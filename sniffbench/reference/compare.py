"""The comparison that decides `correct`.

The reference is what the configuration's guarantees (`configs/*.json`)
say a sniffer reports for the block the transmitter sent, built from the
transmitter's truth alone:

- every placed DCI, at its subframe, RNTI and format;
- every transport block, CRC-ok with the payload that was sent (both
  codewords of a two-codeword grant);
- one MAC-LTE pcap record for each of those blocks.

The block is replayed: window call c (the warm call is c = 0) carries
subframe j of the block at absolute subframe k = c * L + j, which the
sniffer, once its MIB has set the SFN, reports as SFN * 10 + subframe =
k mod 10240.

The numbers compared:
- `wrong_pct`: 100 x (what the reference reports over the window's calls
  that the program did not report as it should: a DCI not found, a block
  not CRC-ok with its payload, a pcap record missing; plus what the
  program reported that the reference does not: a DCI nobody sent, a
  CRC-ok block whose payload was not sent, a pcap record that is not one
  of the reference's) / (everything the reference reports);
- `bad_payloads`: of those, the CRC-ok blocks and pcap records whose
  payload was not sent.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Sequence

from . import pcap as pcap_ref

TTI_WRAP = 10240


def compare(truth: Sequence[dict], calls: Sequence[dict],
            pcap_bodies: Sequence[bytes]) -> dict:
    """truth: per subframe j of the block, dict(dcis=[(rnti, fmt, L,
    ncce)], tbs=[dict(rnti, cw, payload)]).

    calls: per window call, dict(c=call index, dcis=[(tti, [(rnti, fmt)])]
    one entry per subframe the program resolved, in order, results=[(tti,
    rnti, crc_ok, payload or None)] in the order the program appended
    them).

    pcap_bodies: the record bodies the program wrote over those calls."""
    L = len(truth)
    if TTI_WRAP % L:
        raise ValueError(f"a block of {L} subframes does not divide the "
                         f"SFN wrap of {TTI_WRAP}")
    n_ref = missed = extra = 0
    want_pcap: Counter = Counter()
    missed_by = Counter()
    extra_by = Counter()
    examples: List[dict] = []
    for call in calls:
        c = call["c"]
        base = c * L
        # what the program reported, by subframe of the block
        got_dci: Dict[int, Counter] = defaultdict(Counter)
        for tti, acc in call["dcis"]:
            j = (tti - base) % TTI_WRAP
            if j >= L:
                extra += len(acc)
                extra_by["dci_off_block"] += len(acc)
                continue
            got_dci[j].update(acc)
        got_tb: Dict[tuple, List] = defaultdict(list)
        for tti, rnti, crc_ok, payload in call["results"]:
            j = (tti - base) % TTI_WRAP
            got_tb[(j, rnti)].append((crc_ok, payload))
        for j, t in enumerate(truth):
            tti = (base + j) % TTI_WRAP
            sfn, sf = divmod(tti, 10)
            want = Counter((r, f) for r, f, _l, _n in t["dcis"])
            got = got_dci.pop(j, Counter())
            n_ref += sum(want.values())
            m = sum((want - got).values())
            e = sum((got - want).values())
            if (m or e) and len(examples) < 8:
                examples.append(dict(c=c, j=j, missed=sorted(want - got),
                                     extra=sorted(got - want)))
            missed += m
            extra += e
            missed_by["dci"] += m
            extra_by["dci"] += e
            by_rnti = defaultdict(list)
            for tb in t["tbs"]:
                by_rnti[tb["rnti"]].append(tb["payload"])
            for rnti, sent in by_rnti.items():
                # a UE's blocks of this subframe against its CRC-ok
                # results, as multisets of payloads: a second DCI found
                # for the UE adds a result but takes none away
                res = got_tb.pop((j, rnti), [])
                ok = Counter(p for crc_ok, p in res if crc_ok)
                want_tb = Counter(sent)
                for p in sent:
                    n_ref += 2                   # the block and its record
                    want_pcap[pcap_ref.dl_record(p, rnti, sfn, sf)] += 1
                m = sum((want_tb - ok).values())
                e = sum((ok - want_tb).values())
                missed += m
                extra += e
                missed_by["tb"] += m
                extra_by["tb"] += e
        for j in list(got_dci):
            e = sum(got_dci.pop(j).values())
            extra += e
            extra_by["dci"] += e
        for res in got_tb.values():
            e = sum(1 for crc_ok, _p in res if crc_ok)
            extra += e
            extra_by["tb"] += e
    got_pcap = Counter(pcap_bodies)
    m = sum((want_pcap - got_pcap).values())
    e = sum((got_pcap - want_pcap).values())
    missed += m
    extra += e
    missed_by["pcap"] += m
    extra_by["pcap"] += e
    n_tb = sum(want_pcap.values())
    return dict(wrong_pct=100.0 * (missed + extra) / max(1, n_ref),
                bad_payloads=extra_by["tb"] + extra_by["pcap"],
                n_ref=n_ref, n_tb=n_tb, tb_missed=missed_by["tb"],
                missed_by=dict(missed_by), extra_by=dict(extra_by),
                dci_examples=examples)
