// Native blind-search acceptance resolver + RNTI manager (C ABI).
//
// The sequential per-subframe bookkeeping pass of the FALCON blind search —
// the part that cannot batch onto the device because acceptance decisions
// are order-dependent (histogram state mutates between candidates).  The
// reference implements this in C++ (DCISearch.cc / RNTIManager.cc); the
// device delivers per-(location x format) decode results, and this
// resolver replays the CCE-tree pruning at native speed.  Semantics match
// the port's Python resolver (ltesniffer_tpu_torch/sniffer/dci_search.py,
// rnti_manager.py) exactly; tests/test_torch_native.py checks equivalence.
// The port's own copy of the JAX package's native/resolver.cpp, unchanged
// below this header.
//
// Build (ltesniffer_tpu_torch/native.py does it at first use):
//   g++ -O2 -shared -fPIC -std=c++17 -o libresolver.so resolver.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kValueRange = 65536;
constexpr int kIllegal = -1;
constexpr float kPwrThr = 0.7f;

struct Histogram {
  int depth;
  std::vector<uint16_t> history;
  std::vector<int32_t> counts;
  int pos = 0;
  bool ready = false;

  explicit Histogram(int d) : depth(d), history(d, 0), counts(kValueRange, 0) {}

  void add(uint16_t item, int n) {
    while (n-- > 0) {
      if (ready) counts[history[pos]]--;
      history[pos] = item;
      counts[item]++;
      if (++pos == depth) { ready = true; pos = 0; }
    }
  }
  int freq(uint16_t item) const { return counts[item]; }
};

struct Interval { uint16_t lo, hi; };

struct RntiManager {
  int nformats;
  int max_candidates;
  int threshold;
  int64_t lifetime;
  std::vector<Histogram> hist;
  std::vector<std::vector<Interval>> evergreen, forbidden;
  std::vector<uint8_t> active;
  std::vector<int8_t> reason;       // ActivationReason enum values
  std::vector<int64_t> last_seen;
  std::vector<int32_t> assoc_format;
  std::vector<int32_t> remaining;
  int64_t timestamp = 0;

  RntiManager(int nf, int max_cand, int thr, int depth, int64_t life)
      : nformats(nf), max_candidates(max_cand), threshold(thr), lifetime(life),
        evergreen(nf), forbidden(nf), active(kValueRange, 0),
        reason(kValueRange, 0), last_seen(kValueRange, 0),
        assoc_format(kValueRange, 0), remaining(nf, max_cand) {
    for (int i = 0; i < nf; i++) hist.emplace_back(depth);
  }

  bool is_evergreen(int rnti, int f) const {
    for (auto& iv : evergreen[f]) if (rnti >= iv.lo && rnti <= iv.hi) return true;
    return false;
  }
  bool is_forbidden(int rnti, int f) const {
    for (auto& iv : forbidden[f]) if (rnti >= iv.lo && rnti <= iv.hi) return true;
    return false;
  }
  void add_candidate(int rnti, int f) {
    hist[f].add((uint16_t)rnti, 1);
    remaining[f]--;
  }
  int get_frequency(int rnti, int f) const { return hist[f].freq((uint16_t)rnti); }

  int likely_dl_format(int rnti) const {
    int best = 0, best_f = 0;  // 0 == uncertain
    for (int f = 1; f < nformats; f++) {
      int c = hist[f].freq((uint16_t)rnti);
      if (c > best) { best = c; best_f = f; }
    }
    return best_f;
  }

  void activate(int rnti, int8_t why) {
    if (!active[rnti]) { active[rnti] = 1; reason[rnti] = why; }
  }
  void deactivate(int rnti) {
    if (active[rnti]) { active[rnti] = 0; assoc_format[rnti] = 0; reason[rnti] = 0; }
  }

  bool validate_by_histogram(int rnti, int f) {
    int likely = likely_dl_format(rnti);
    if (f != 0 && f != likely) return false;
    int ul = hist[0].freq((uint16_t)rnti);
    int dl = likely != 0 ? hist[likely].freq((uint16_t)rnti) : 0;
    if (ul + dl > threshold) {
      activate(rnti, 4 /*HISTOGRAM*/);
      assoc_format[rnti] = dl > threshold ? likely : 0;
      return true;
    }
    return false;
  }

  bool validate(int rnti, int f) {
    if (is_evergreen(rnti, f)) return true;
    if (is_forbidden(rnti, f)) return false;
    if (active[rnti]) {
      if (timestamp - last_seen[rnti] < lifetime) return true;
      deactivate(rnti);
    }
    return validate_by_histogram(rnti, f);
  }

  bool validate_and_refresh(int rnti, int f) {
    bool ok = validate(rnti, f);
    if (ok) last_seen[rnti] = timestamp;
    return ok;
  }

  void activate_and_refresh(int rnti, int f, int8_t why) {
    activate(rnti, why);
    last_seen[rnti] = timestamp;
    assoc_format[rnti] = f;
  }

  int8_t activation_reason(int rnti) const {
    return active[rnti] ? reason[rnti] : 0;
  }

  void step_time(int n) {
    while (n-- > 0) {
      for (int f = 0; f < nformats; f++) {
        if (remaining[f] > 0) hist[f].add(0 /*ILLEGAL_RNTI*/, remaining[f]);
        remaining[f] = max_candidates;
      }
      timestamp++;
    }
  }
};

// ---------------------------------------------------------------------------
// search spaces (36.213 9.1.1) — mirrors phy/search_space.py
// ---------------------------------------------------------------------------
int yk(int rnti, int sf_idx) {
  int64_t y = rnti;
  for (int i = 0; i <= sf_idx; i++) y = (39827 * y) % 65537;
  return (int)y;
}

constexpr int kNofUeCand[4] = {6, 6, 2, 2};

int validate_location(int nof_cce, int ncce, int l, int sf_idx, int rnti) {
  bool valid = false, ambiguous = false;
  auto check = [&](int cl, int cncce) {
    if (cncce == ncce) {
      if (l > 0 && cl == l - 1) ambiguous = true;
      if (cl == l) valid = true;
    }
  };
  bool want_ue = (rnti >= 0x003D && rnti <= 0xFFF3);
  bool want_common = (rnti >= 0x0001 && rnti <= 0x003C) || want_ue ||
                     (rnti >= 0xFFFD && rnti <= 0xFFFF);
  if (want_ue) {
    int y = yk(rnti, sf_idx);
    for (int cl = 3; cl >= 0; cl--) {
      int L = 1 << cl;
      if (nof_cce < L) continue;
      for (int i = 0; i < kNofUeCand[cl]; i++) {
        int c = L * ((y + i) % (nof_cce / L));
        if (c + L <= nof_cce) check(cl, c);
      }
    }
  }
  if (want_common) {
    for (int cl = 3; cl >= 2; cl--) {
      int L = 1 << cl;
      int lim = (nof_cce < 16 ? nof_cce : 16) / L;
      for (int i = 0; i < lim; i++) {
        int c = L * (i % (nof_cce / L));
        if (c + L <= nof_cce) check(cl, c);
      }
    }
  }
  if (!valid) return 0;
  return ambiguous ? 1 : 2;
}

// ---------------------------------------------------------------------------
// the resolver
// ---------------------------------------------------------------------------
struct Loc {
  int l, ncce;
  bool used = false, occupied = false, checked = false, sufficient_power = true;
  int index = -1;  // position in the location list
};

struct ResolveCtx {
  RntiManager* rm;
  int n_loc, n_formats, nof_cce, sf_idx;
  const int32_t* cand_rnti;     // (n_loc, n_formats): decoded RNTI
  const int8_t* cand_resolved;  // (n_loc, n_formats): resolved fmt idx or -1
  const int32_t* loc_l;         // (n_loc,)
  const int32_t* loc_ncce;
  std::vector<Loc> locs;
  std::vector<std::vector<Loc*>> cce_map;  // [cce][aggr]
  std::vector<int> loc_at;                 // (4*85) index lookup
  // RAR DCI0 side list
  struct TempDci { int rnti, fmt, l, ncce, fi; };
  std::vector<TempDci> temp_dci0;
  // outputs
  int32_t* out;     // rows of 6: loc_idx, fmt_idx, rnti, l_disamb, ncce, histval
  int out_cap, out_n = 0;
  int64_t decoded_locations = 0;

  Loc* loc_of(int l, int ncce) {
    if (ncce >= nof_cce) return nullptr;
    return cce_map[ncce][l];
  }
  int loc_index(int l, int ncce) {
    for (int i = 0; i < n_loc; i++)
      if (loc_l[i] == l && loc_ncce[i] == ncce) return i;
    return -1;
  }
};

// format index of "0" in the global ordering
constexpr int kFmt0 = 0;
constexpr int kFmt1A = 2;
constexpr int kFmt1C = 4;

int inspect(ResolveCtx& c, int ncce, int l, int depth, bool discovery,
            const int32_t* parent) {
  // span check (not just start): with the unified cfi-dynamic search the
  // location list is the cfi=3 superset, so the location must fit entirely
  // inside this subframe's control region
  if (ncce + (1 << l) > c.nof_cce) return 0;
  Loc* loc = c.loc_of(l, ncce);
  if (!loc || loc->occupied || loc->checked || !loc->sufficient_power) return 0;
  int li = loc->index;
  c.decoded_locations += c.n_formats;

  std::vector<int32_t> rntis(c.n_formats);
  std::vector<int> match(c.n_formats, 0);
  int nof_above = 0, hist_max_idx = -1, hist_max_val = 0;
  for (int fi = 0; fi < c.n_formats; fi++) {
    int rnti = c.cand_rnti[li * c.n_formats + fi];
    int resolved = c.cand_resolved[li * c.n_formats + fi];
    rntis[fi] = rnti;
    // RAR-activated DCI0 side list
    if (c.rm->activation_reason(rnti) == 2 /*RAR*/ && resolved == kFmt0) {
      bool dup = false;
      for (auto& t : c.temp_dci0)
        if (t.fmt == kFmt0 && t.rnti == rnti && t.ncce == ncce) dup = true;
      if (!dup) c.temp_dci0.push_back({rnti, kFmt0, l, ncce, fi});
    }
    if (resolved != fi) { rntis[fi] = kIllegal; continue; }
    if (fi == kFmt1C && rnti > 0x003C && rnti < 0xFFFE) {
      rntis[fi] = kIllegal; continue;
    }
    if (rnti > 0x0001 && rnti < 0x003C && fi != kFmt1A && fi != kFmt1C) {
      rntis[fi] = kIllegal; continue;
    }
    if (discovery && parent && parent[fi] == rnti &&
        !c.rm->is_forbidden(rnti, fi)) {
      return -(fi + 1);
    }
    match[fi] = validate_location(c.nof_cce, ncce, l, c.sf_idx, rnti);
    if (match[fi] == 0) { rntis[fi] = kIllegal; continue; }
    if (c.rm->validate_and_refresh(rnti, fi)) {
      nof_above++;
      hist_max_idx = fi;
      hist_max_val = c.rm->get_frequency(rnti, fi);
    }
  }

  if (nof_above > 1) {
    hist_max_idx = -1;
    int hist_max = 0;
    for (int fi = 0; fi < c.n_formats; fi++) {
      if (rntis[fi] != kIllegal) {
        int h = c.rm->get_frequency(rntis[fi], fi);
        if (h > hist_max) { hist_max = h; hist_max_idx = fi; hist_max_val = h; }
      }
    }
    if (hist_max_idx == -1) nof_above = 0;
  }

  loc->checked = true;
  int disamb = 0;

  if (nof_above > 0 && match[hist_max_idx] == 1) {
    if (l > 0 && depth > 0)
      disamb = inspect(c, ncce + (1 << (l - 1)), l - 1, depth - 1, false,
                       nullptr);
  } else if (nof_above == 0) {
    int rec = 0;
    if (l > 0 && depth > 0) {
      rec += inspect(c, ncce, l - 1, depth - 1, discovery, rntis.data());
      if (rec < 0) {
        hist_max_idx = -rec - 1;
        hist_max_val = c.rm->get_frequency(rntis[hist_max_idx], hist_max_idx);
        nof_above = 1;
        if (match[hist_max_idx] == 1 && l > 0)
          disamb = inspect(c, ncce + (1 << (l - 1)), l - 1, depth - 1, false,
                           nullptr);
        c.rm->activate_and_refresh(rntis[hist_max_idx], hist_max_idx,
                                   3 /*SHORTCUT*/);
      } else {
        rec += inspect(c, ncce + (1 << (l - 1)), l - 1, depth - 1, discovery,
                       nullptr);
      }
    }
    if (rec == 0) {
      if (discovery) {
        for (int fi = 0; fi < c.n_formats; fi++)
          if (rntis[fi] != kIllegal) c.rm->add_candidate(rntis[fi], fi);
      }
      return 0;
    }
    if (rec > 0) return rec;
  }

  if (nof_above > 0) {
    loc->used = true;
    int span = 1 << l;
    for (int cc = ncce; cc < ncce + span && cc < c.nof_cce; cc++)
      for (int aggr = 0; aggr < 4; aggr++)
        if (c.cce_map[cc][aggr]) {
          c.cce_map[cc][aggr]->occupied = true;
          c.cce_map[cc][aggr]->checked = true;
        }
    int rnti = rntis[hist_max_idx];
    c.rm->add_candidate(rnti, hist_max_idx);
    int l_disamb = disamb > 0 ? l - 1 : l;
    if (rnti != 0) {
      bool add = true;
      if (hist_max_idx == kFmt0) {
        for (auto& t : c.temp_dci0)
          if (t.fmt == kFmt0 && t.rnti == rnti && t.ncce == ncce) add = false;
      }
      if (add && c.out_n < c.out_cap) {
        int32_t* row = c.out + 6 * c.out_n++;
        row[0] = li; row[1] = hist_max_idx; row[2] = rnti;
        row[3] = l_disamb; row[4] = ncce; row[5] = hist_max_val;
      }
      for (auto& t : c.temp_dci0) {
        if (c.out_n < c.out_cap) {
          int tl = c.loc_index(t.l, t.ncce);
          int32_t* row = c.out + 6 * c.out_n++;
          row[0] = tl; row[1] = kFmt0; row[2] = t.rnti;
          row[3] = t.l; row[4] = t.ncce;
          row[5] = c.rm->get_frequency(t.rnti, t.fi);
        }
      }
      c.temp_dci0.clear();
    }
    return 1 + disamb;
  }
  return 0;
}

}  // namespace

extern "C" {

void* rm_create(int nformats, int max_cand, int threshold, int depth,
                int64_t lifetime) {
  return new RntiManager(nformats, max_cand, threshold, depth, lifetime);
}
void rm_destroy(void* p) { delete (RntiManager*)p; }
void rm_add_evergreen(void* p, int lo, int hi, int f) {
  ((RntiManager*)p)->evergreen[f].push_back({(uint16_t)lo, (uint16_t)hi});
}
void rm_add_forbidden(void* p, int lo, int hi, int f) {
  ((RntiManager*)p)->forbidden[f].push_back({(uint16_t)lo, (uint16_t)hi});
}
void rm_step_time(void* p, int n) { ((RntiManager*)p)->step_time(n); }
void rm_add_candidate(void* p, int rnti, int f) {
  ((RntiManager*)p)->add_candidate(rnti, f);
}
int rm_get_frequency(void* p, int rnti, int f) {
  return ((RntiManager*)p)->get_frequency(rnti, f);
}
int rm_validate_and_refresh(void* p, int rnti, int f) {
  return ((RntiManager*)p)->validate_and_refresh(rnti, f) ? 1 : 0;
}
void rm_activate_and_refresh(void* p, int rnti, int f, int why) {
  ((RntiManager*)p)->activate_and_refresh(rnti, f, (int8_t)why);
}
int rm_activation_reason(void* p, int rnti) {
  return ((RntiManager*)p)->activation_reason(rnti);
}
int rm_is_active(void* p, int rnti) { return ((RntiManager*)p)->active[rnti]; }
int64_t rm_timestamp(void* p) { return ((RntiManager*)p)->timestamp; }
int rm_active_count(void* p) {
  auto* rm = (RntiManager*)p;
  int n = 0;
  for (int r = 0; r < kValueRange; r++) {
    if (rm->active[r]) {
      if (rm->timestamp - rm->last_seen[r] >= rm->lifetime) rm->deactivate(r);
      else n++;
    }
  }
  return n;
}
int rm_active_set(void* p, int32_t* out_rnti, int8_t* out_reason, int cap) {
  auto* rm = (RntiManager*)p;
  int n = 0;
  for (int r = 0; r < kValueRange && n < cap; r++) {
    if (rm->active[r]) {
      if (rm->timestamp - rm->last_seen[r] >= rm->lifetime) { rm->deactivate(r); continue; }
      out_rnti[n] = r;
      out_reason[n] = rm->reason[r];
      n++;
    }
  }
  return n;
}

// Returns number of accepted DCIs written to `out` (rows of 6 int32).
// snr_gate: if 0, the subframe was below the SNR gate — only step time.
int resolve_subframe(void* rm_ptr, int n_loc, int n_formats, int nof_cce,
                     int sf_idx, int snr_ok,
                     const int32_t* loc_l, const int32_t* loc_ncce,
                     const int32_t* cand_rnti, const int8_t* cand_resolved,
                     const float* cce_power,
                     int32_t* out, int out_cap, int64_t* stats_out) {
  auto* rm = (RntiManager*)rm_ptr;
  if (!snr_ok) return 0;
  ResolveCtx c;
  c.rm = rm;
  c.n_loc = n_loc; c.n_formats = n_formats; c.nof_cce = nof_cce;
  c.sf_idx = sf_idx;
  c.cand_rnti = cand_rnti; c.cand_resolved = cand_resolved;
  c.loc_l = loc_l; c.loc_ncce = loc_ncce;
  c.out = out; c.out_cap = out_cap;
  c.locs.resize(n_loc);
  c.cce_map.assign(nof_cce, std::vector<Loc*>(4, nullptr));
  for (int i = 0; i < n_loc; i++) {
    Loc& lo = c.locs[i];
    lo.l = loc_l[i]; lo.ncce = loc_ncce[i]; lo.index = i;
    int span = 1 << lo.l;
    for (int cc = lo.ncce; cc < lo.ncce + span && cc < nof_cce; cc++)
      c.cce_map[cc][lo.l] = &lo;
  }
  int64_t missed = 0;
  for (int cc = 0; cc < nof_cce; cc++) {
    if (cce_power[cc] < kPwrThr)
      for (int aggr = 0; aggr < 4; aggr++)
        if (c.cce_map[cc][aggr]) c.cce_map[cc][aggr]->sufficient_power = false;
  }
  for (int i = 0; i < n_loc; i++)
    inspect(c, loc_ncce[i], loc_l[i], 99, true, nullptr);
  for (int cc = 0; cc < nof_cce; cc++) {
    if (cce_power[cc] >= kPwrThr) {
      bool used = false;
      for (int aggr = 0; aggr < 4; aggr++)
        if (c.cce_map[cc][aggr] && c.cce_map[cc][aggr]->used) used = true;
      if (!used) missed++;
    }
  }
  rm->step_time(1);
  if (stats_out) {
    stats_out[0] = c.decoded_locations;
    stats_out[1] = missed;
  }
  return c.out_n;
}

}  // extern "C"
