"""Every UE's MCS table reads as known to be 64QAM: no dual-table trial
and no learning of the 256QAM table, the step a later change could take
to save the retry's dispatch.  Breaks the guarantee that a block is
decoded on the table its UE uses."""


def plant(core) -> None:
    from ltesniffer_tpu_torch.sniffer import trackers
    core.mcs.dl_table_of = lambda rnti: trackers.McsTable.QAM64
