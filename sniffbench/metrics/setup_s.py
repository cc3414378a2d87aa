"""Process start to the end of the warm block: making the input, imports,
the program's builds (first run in a checkout), the core, the warm block."""


def read(rec):
    return rec["setup_s"]
