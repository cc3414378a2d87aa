"""A block that fails its CRC after the primary turbo iterations is given
up, not decoded again at the full iteration count: the step a later change
could take to save the escalation's dispatch.  Breaks the guarantee that
every transport block is decoded."""


def plant(core) -> None:
    core.cfg.turbo_iters_max = core.cfg.turbo_iters
