"""Stream scenarios for the live entry point, built in memory.

Unaligned captures, as a radio delivers them, made from the port's own
generators:

* `build_dl_stream`: the loaded cell (`loaded_cell.build_stream`, 20 MHz,
  512 subframes) behind a lead of LEAD complex-Gaussian noise samples
  (sigma NOISE_SIGMA), the whole stream mixed by a CFO of CFO_SC
  subcarriers (300 Hz at 15 kHz spacing), and GAP_SF subframes cut out
  at sample `sf_len * GAP_AT_SF + GAP_OFFSET` (the tracker loses the PSS,
  re-acquires, and the core re-acquires the SFN from the MIB).  It is read
  through `ArraySource(chunk_limit=dl_chunk_limit())`, so every block
  ends mid-subframe.  The cell search of both packages cannot acquire the
  loaded cell as it is: its PDSCH fills the PSS symbol, and the PSS
  metric, normalized by the whole symbol's energy, stays near 0.15
  against `find_cell`'s threshold of 0.3.  So the stream run takes the
  same cell with subframes 0 and 5 free of grants (PDSCH_FREE_SF), and
  the loaded cell's own stream is held to the same acquisition failure.
* `build_ul_streams`: the UL cell (`ul_cell.build_streams`, 20 MHz, 512
  subframes), both carriers behind a LEAD-sample noise lead, the UL
  content UL_SKEW samples later than the DL's (`run_dual_source`'s
  `ul_skew`).
* `golden_scenario`: tests/test_golden_replay.py's DL golden stream
  (50 PRB, 20 subframes), and `cli_stream`, the same behind a
  CLI_LEAD-sample noise lead, as the CLI's `--sync` reads it from a file.

The expected records beside this module (`dl_stream_expected.json`,
`ul_stream_expected.json`, `ingest_expected.json`,
`cli_expected.json`) are the JAX package's CPU runs over these streams
(regen commands in tests/test_torch_stream.py and test_torch_cli.py).
Nothing is written to disk.
"""
from __future__ import annotations

import numpy as np

from ltesniffer_tpu_torch.testing import loaded_cell, ul_cell

N_SF = 512
LEAD = 1000
NOISE_SIGMA = 0.01
NOISE_SEED = 5
CFO_SC = 0.02
GAP_AT_SF = 200
GAP_OFFSET = 500
GAP_SF = 2.5
# the subframes (0-9) left without grants in the stream run's cell (the
# PSS/SSS subframes); () builds the loaded cell as it is
PDSCH_FREE_SF = (0, 5)
UL_SKEW = 37
CLI_LEAD = 777
# run_source's settings: the CLI's defaults, blocks of 3 subframes + 777
BATCH = 32
CHUNK_SUBFRAMES = 256


def dl_chunk_limit() -> int:
    return 3 * loaded_cell.CELL.sf_len + 777


def noise(k: int, rng) -> np.ndarray:
    """k complex-Gaussian samples of total standard deviation NOISE_SIGMA."""
    return (NOISE_SIGMA / np.sqrt(2) * (rng.standard_normal(k)
                                        + 1j * rng.standard_normal(k))
            ).astype(np.complex64)


def impair(stream: np.ndarray, n_fft: int, sf_len: int, rng,
           lead: int = LEAD, cfo: float = CFO_SC,
           gap_at: int = None, gap_sf: float = GAP_SF) -> np.ndarray:
    """A noise lead of `lead` samples, then the whole stream mixed by `cfo`
    subcarriers, then `gap_sf` subframes cut at sample `sf_len * gap_at +
    GAP_OFFSET` of the mixed stream (no cut when `gap_at` is None)."""
    x = np.concatenate([noise(lead, rng), stream])
    if cfo:
        n = np.arange(len(x))
        x = (x * np.exp(2j * np.pi * cfo * n / n_fft)).astype(np.complex64)
    if gap_at is not None:
        cut = sf_len * gap_at + GAP_OFFSET
        x = np.concatenate([x[:cut], x[cut + int(sf_len * gap_sf):]])
    return x


def dl_params() -> dict:
    """The DL stream's parameters, as its expected record stores them."""
    return dict(loaded_cell.params(N_SF), pdsch_free_sf=list(PDSCH_FREE_SF),
                lead=LEAD, noise_sigma=NOISE_SIGMA,
                noise_seed=NOISE_SEED, cfo_sc=CFO_SC, gap_at_sf=GAP_AT_SF,
                gap_offset=GAP_OFFSET, gap_sf=GAP_SF,
                chunk_limit=dl_chunk_limit(), batch_size=BATCH,
                chunk_subframes=CHUNK_SUBFRAMES)


def build_dl_stream(n_sf: int = N_SF, pdsch_free_sf=PDSCH_FREE_SF):
    """-> (the impaired loaded-cell stream, placed TBs, per-TB truth);
    `pdsch_free_sf=()` gives the loaded cell as it is."""
    stream, placed, truth = loaded_cell.build_stream(
        n_sf=n_sf, pdsch_free_sf=pdsch_free_sf)
    cell = loaded_cell.CELL
    x = impair(stream, cell.n_fft, cell.sf_len,
               np.random.default_rng(NOISE_SEED), gap_at=GAP_AT_SF)
    return x, placed, truth


def ul_params() -> dict:
    """The dual stream's parameters, as its expected record stores them."""
    return dict(ul_cell.params(N_SF), lead=LEAD, noise_sigma=NOISE_SIGMA,
                noise_seed=NOISE_SEED, ul_skew=UL_SKEW,
                batch_size=ul_cell.BATCH, chunk_subframes=CHUNK_SUBFRAMES)


def build_ul_streams(n_sf: int = N_SF):
    """-> (DL stream, UL stream, placed DCI0s, truth as
    `ul_cell.build_streams` gives it): both behind a noise lead, the UL
    content UL_SKEW samples later than the DL's."""
    dl, ul, placed, truth = ul_cell.build_streams(n_sf=n_sf)
    rng = np.random.default_rng(NOISE_SEED)
    return (np.concatenate([noise(LEAD, rng), dl]),
            np.concatenate([noise(LEAD + UL_SKEW, rng), ul]), placed, truth)


def golden_scenario():
    """tests/test_golden_replay.py:_build_stream, through the port:
    (cell, stream, truth)."""
    from ltesniffer_tpu_torch.mac_rrc import mac, rrc
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.testing import scenario
    cell = CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    sb = scenario.ScenarioBuilder(cell, seed=20260817, noise=0.04)
    sib2 = rrc.encode_sib2(rrc.Sib2UlConfig(cyclic_shift=2))
    ue_pdu = mac.build_mac_pdu([mac.MacSubPdu(lcid=3,
                                              payload=b"golden-ue-data")])
    pg = rrc.encode_paging([rrc.PagingRecord(s_tmsi=0x1122334455)])
    for j in range(20):
        sf = j % 10
        txs = []
        if sf == 5:
            txs.append(scenario.DlTx(rnti=0xFFFF, mac_pdu=sib2, n_prb=6))
        if sf == 0:
            txs.append(scenario.DlTx(rnti=0xFFFE, mac_pdu=pg, n_prb=6,
                                     prb_start=40))
        if j >= 2:
            txs.append(scenario.DlTx(rnti=0x4D2, mac_pdu=ue_pdu, n_prb=10,
                                     prb_start=12, ndi=j % 2,
                                     harq_pid=j % 8))
        sb.add_subframe(sf, txs)
    return cell, sb.stream(), sb.truth


# the ingest options the card runs the golden scenario under (the
# expected record holds every ingest x depth pair)
CHIP_INGEST = (("i16", 3), ("f32", 3), ("i8", 1), ("i8", 2))


def ingest_key(ingest: str, depth: int) -> str:
    return f"{ingest}/depth{depth}"


def cli_stream(stream: np.ndarray) -> np.ndarray:
    """The golden stream behind a CLI_LEAD-sample noise lead."""
    return np.concatenate([noise(CLI_LEAD, np.random.default_rng(NOISE_SEED)),
                           stream])


def cli_args(cell, iq_path: str, pcap_path: str, stats_path: str) -> list:
    """The CLI arguments the record and the card run with (`--sync`, the
    stream tracker)."""
    return ["-i", iq_path, "-c", str(cell.n_id_cell), "-p", str(cell.n_prb),
            "-P", str(cell.nof_ports), "--sync", "-o", pcap_path,
            "--stats-json", stats_path]


# stats keys that are wall-clock readings, not counts
CLI_CLOCK_KEYS = ("wall_s", "subframes_per_s")
