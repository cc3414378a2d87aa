"""One module per control (a workload file's `control` key): `plant(core)`
breaks one guarantee of the configuration in the program as built, the
step a later change could take to save time.  `control.py` reads the
cell's readings with it; the benchmark's own runs never plant one."""
