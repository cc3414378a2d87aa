"""One module per configuration `mode` (the configuration file's key):
the program's entry for that mode and what the reference compares.

A mode module gives:

- `build_input(config, mix, seed, workers, n_sf)` -> (inputs, truth):
  the cell's input block and the transmitter's truth, one entry a
  subframe;
- `make_core(config, device, pcap_path)` -> the program's core at its
  defaults but for the cell, the device and the pcap;
- `Recorder(core)`: installs what the window records of each call,
  compactly (`start_call()` before each call, `calls()` after the
  window: the per-call outputs that `compare` reads);
- `call(core, inputs, sf_idx0)`: one call of the timed entry;
- `compare(truth, calls, pcap_bodies)` -> the numbers of `correct`, with
  `n_tb` and `tb_missed`;
- `PHASES`: the core's phase methods, named in the traced run's gaps;
- `work_tbs(truth)`: the TBS of every transport block one block sends.
"""
