// Host-native CTC prefix beam search with n-gram LM shallow fusion
// (the port's copy of the JAX package's native/ctc_beam.cpp, ABI
// version 3; the one change is its tie-break, below).
//
// The analogue of the reference's ctcdecode C++ extension (+ the KenLM
// scoring path linked into it). The device decoder (K3,
// tpuasr_torch/decode/beam.py) is the GPU path; this one decodes on
// the host: batch decoding with a word-level LM where ctcdecode was
// used (--decoder beam-native), and one stateful session per live
// stream (--beam-impl native).
//
// The LM is a flat open-addressed hash file written by
// tpuasr_torch.decode.native.write_lm_binary: 64-bit splitmix hashes of
// UTF-8 token sequences -> (natural-log prob, backoff), one table per
// n-gram order. Hashing matches tpuasr_torch/decode/lm.py token_hash /
// context_hash bit-for-bit.
//
// One change from the JAX package's copy: exact ties are broken the
// same way as tpuasr_torch/decode/beam_host.py breaks them, so the two
// host searches keep the same beams on bf16 logits, where two classes
// often carry the same log-probability and two extensions of one beam
// then score exactly alike. Candidates of equal log-probability rank by
// class id, beams of equal score by their prefix (lexicographic ids),
// and the best of equal beams is the one whose prefix comes first.
//
// Build: at first use, by tpuasr_torch/ops/_build.py build_host (the
//        host compiler $CXX, default c++, into build/)
// Bind:  ctypes, tpuasr_torch/decode/native.py

#include <algorithm>
#include <atomic>
#include <cmath>
#include <numeric>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNeg = -1e30f;

inline float lse(float a, float b) {
  if (a < b) std::swap(a, b);
  if (b <= kNeg / 2) return a;
  return a + std::log1p(std::exp(b - a));
}

// ---- 64-bit hashing (must match tpuasr_torch/decode/lm.py) ----
constexpr uint64_t kMult = 0x9E3779B97F4A7C15ull;

inline uint64_t mix64(uint64_t h, uint64_t x) {
  h = (h ^ x) * kMult;
  return h ^ (h >> 29);
}

uint64_t token_hash(const std::string& tok) {
  uint64_t h = 1469598103934665603ull;
  for (unsigned char c : tok) h = mix64(h, c);
  return h;
}

struct LmTable {
  std::vector<uint64_t> keys;
  std::vector<float> logp;
  std::vector<float> backoff;

  bool lookup(uint64_t h, float* lp, float* bo) const {
    if (keys.empty()) return false;
    size_t cap = keys.size();
    size_t slot = h % cap;
    for (size_t i = 0; i < cap; ++i) {
      if (keys[slot] == h) {
        *lp = logp[slot];
        *bo = backoff[slot];
        return true;
      }
      if (keys[slot] == 0) return false;
      slot = (slot + 1) % cap;
    }
    return false;
  }
};

struct Lm {
  int order = 0;
  std::vector<LmTable> tables;
  uint64_t unk_hash = 0;

  bool in_vocab(uint64_t tok_h) const {
    float lp, bo;
    uint64_t h = mix64(0, tok_h);
    return tables[0].lookup(h ? h : 1ull, &lp, &bo);
  }

  // log P(word | context words), Katz backoff; natural log. Matches
  // tpuasr_torch.decode.lm.ArpaLM.score_word: OOV tokens (word and context)
  // canonicalize to <unk>; a word missing even as <unk> scores the
  // ARPA "-99" floor (log10) in natural log.
  float score(const std::vector<uint64_t>& ctx_hashes,
              uint64_t word_h) const {
    if (!in_vocab(word_h)) word_h = unk_hash;
    std::vector<uint64_t> ctx = ctx_hashes;
    for (auto& t : ctx)
      if (!in_vocab(t)) t = unk_hash;
    int max_ctx = std::min<int>((int)ctx.size(), order - 1);
    float bo_acc = 0.0f;
    for (int m = max_ctx; m >= 0; --m) {
      uint64_t h = 0;
      for (int i = (int)ctx.size() - m; i < (int)ctx.size(); ++i)
        h = mix64(h, ctx[i]);
      uint64_t full = mix64(h, word_h);
      float lp, bo;
      if (tables[m].lookup(full ? full : 1ull, &lp, &bo)) return bo_acc + lp;
      if (m > 0) {
        uint64_t ctx_only = h;
        float clp, cbo;
        if (tables[m - 1].lookup(ctx_only ? ctx_only : 1ull, &clp, &cbo))
          bo_acc += cbo;
      }
    }
    // unigram floor still carries the accumulated backoff chain
    // (parity with ArpaLM.score_word: bo + ... + bo + floor)
    return bo_acc + -227.9559f;  // -99 in log10 (ARPA impossible)
  }
};

struct Beam {
  std::vector<int> prefix;
  // per-character emission frame (same length as prefix): the frame
  // of the DOMINANT alignment's first emission of each char — the
  // identical rule to the device kernel's stay<->extend absorption
  // (tpuasr/decode/beam.py "Representative identity" comment in the
  // JAX package), so
  // device/host/native offsets agree.
  std::vector<int> frames;
  float pb = kNeg;   // ends in blank
  float pnb = kNeg;  // ends in non-blank
  float lm = 0.0f;   // accumulated alpha*logP_lm + beta*words
  // within-frame scratch for the dominant-alignment frames rule:
  // mass arriving with the prefix unchanged (blank / repeat) vs via
  // extension (parent + c); resolved once per advance().
  float stay_acc = kNeg;
  float ext_acc = kNeg;
  std::vector<int> ext_frames;
  float total() const { return lse(pb, pnb) + lm; }
};

struct PrefixHash {
  size_t operator()(const std::vector<int>& v) const {
    uint64_t h = 14695981039346656037ull;
    for (int x : v) h = mix64(h, (uint64_t)(x + 1));
    return (size_t)h;
  }
};

struct DecodeConfig {
  int blank = 0;
  int space = -1;
  int beam_width = 10;
  float alpha = 0.0f;
  float beta = 0.0f;
  int cutoff_top_n = 40;
  float cutoff_prob = 1.0f;
  // drop candidates with log-prob <= this (parity with the Python
  // beam_step's prune_logp; blank is always kept)
  float prune_logp = -1e30f;
};

// characters since last space -> UTF-8 word string
std::string last_word(const std::vector<int>& prefix, int space,
                      const std::vector<std::string>& labels) {
  std::string w;
  std::vector<int> chars;
  for (auto it = prefix.rbegin(); it != prefix.rend(); ++it) {
    if (*it == space) break;
    chars.push_back(*it);
  }
  for (auto it = chars.rbegin(); it != chars.rend(); ++it)
    w += labels[*it];
  return w;
}

// hashes of completed words in the prefix (BOS first)
std::vector<uint64_t> context_words(const std::vector<int>& prefix, int space,
                                    const std::vector<std::string>& labels) {
  std::vector<uint64_t> out;
  out.push_back(token_hash("<s>"));
  std::string cur;
  for (int c : prefix) {
    if (c == space) {
      if (!cur.empty()) out.push_back(token_hash(cur));
      cur.clear();
    } else {
      cur += labels[c];
    }
  }
  // cur = in-progress word (the one being closed by the caller)
  return out;
}

using BeamMap = std::unordered_map<std::vector<int>, Beam, PrefixHash>;

BeamMap beams_init() {
  BeamMap beams;
  Beam root;
  root.pb = 0.0f;
  beams.emplace(std::vector<int>{}, root);
  return beams;
}

// One frame of prefix-beam expansion + width pruning (shared by the
// batch decoder and the incremental session API). ``lp`` = one (C,)
// row of log-probabilities; ``cand`` is scratch of size >= C; ``t``
// is the absolute frame index recorded as new chars' emission frame.
void advance(BeamMap& beams, const float* lp, int C,
             const DecodeConfig& cfg, const Lm* lm,
             const std::vector<std::string>& labels,
             std::vector<int>& cand, int t) {
  // candidate pruning: top-n + cumulative prob cutoff
  std::iota(cand.begin(), cand.begin() + C, 0);
  std::sort(cand.begin(), cand.begin() + C,
            [&](int a, int b) { return lp[a] > lp[b] || (lp[a] == lp[b] && a < b); });
  int keep = C;
  if (cfg.cutoff_prob < 1.0f) {
    float cum = 0.0f;
    for (int i = 0; i < C; ++i) {
      cum += std::exp(lp[cand[i]]);
      if (cum >= cfg.cutoff_prob) { keep = i + 1; break; }
    }
  }
  keep = std::min(keep, cfg.cutoff_top_n);

  BeamMap next;
  next.reserve(beams.size() * (keep + 1));

  for (auto& kv : beams) {
    const std::vector<int>& prefix = kv.first;
    const Beam& b = kv.second;
    float p_tot = lse(b.pb, b.pnb);
    int last = prefix.empty() ? -1 : prefix.back();

    for (int i = 0; i < keep; ++i) {
      int c = cand[i];
      float lpc = lp[c];
      if (c != cfg.blank && lpc <= cfg.prune_logp) continue;
      if (c == cfg.blank) {
        Beam& e = next[prefix];
        if (e.prefix.empty() && !prefix.empty()) e.prefix = prefix;
        e.pb = lse(e.pb, p_tot + lpc);
        e.lm = b.lm;
        e.stay_acc = lse(e.stay_acc, p_tot + lpc);
        e.frames = b.frames;  // stay source is unique (same prefix)
        continue;
      }
      float contrib;
      if (c == last) {
        Beam& e = next[prefix];
        if (e.prefix.empty() && !prefix.empty()) e.prefix = prefix;
        e.pnb = lse(e.pnb, b.pnb + lpc);
        e.lm = b.lm;
        e.stay_acc = lse(e.stay_acc, b.pnb + lpc);
        e.frames = b.frames;
        contrib = b.pb + lpc;
      } else {
        contrib = p_tot + lpc;
      }
      std::vector<int> np = prefix;
      np.push_back(c);
      float lm_new = b.lm;
      if (lm && c == cfg.space) {
        std::string w = last_word(prefix, cfg.space, labels);
        if (!w.empty()) {
          auto ctx = context_words(prefix, cfg.space, labels);
          lm_new += cfg.alpha * lm->score(ctx, token_hash(w)) + cfg.beta;
        }
      }
      Beam& e = next[np];
      e.prefix = std::move(np);
      e.pnb = lse(e.pnb, contrib);
      e.lm = lm_new;
      e.ext_acc = lse(e.ext_acc, contrib);
      if (e.ext_frames.empty()) {  // ext source is unique (parent, c)
        e.ext_frames = b.frames;
        e.ext_frames.push_back(t);
      }
    }
  }

  // Resolve each merged candidate's frames: the DOMINANT contributor
  // (extension strictly outweighing the stay mass) donates its
  // emission frames — the same tie-break as the device kernel's
  // take_ext = best_ext_val > stay_score_pre.
  for (auto& kv : next) {
    Beam& e = kv.second;
    if (!e.ext_frames.empty() &&
        (e.ext_acc > e.stay_acc || e.frames.size() != kv.first.size()))
      e.frames = std::move(e.ext_frames);
    e.stay_acc = kNeg;
    e.ext_acc = kNeg;
    e.ext_frames.clear();
  }

  // prune to beam width
  std::vector<std::pair<float, const std::vector<int>*>> scored;
  scored.reserve(next.size());
  for (auto& kv : next) scored.push_back({kv.second.total(), &kv.first});
  int w = std::min<int>(cfg.beam_width, (int)scored.size());
  std::partial_sort(scored.begin(), scored.begin() + w, scored.end(),
                    [](auto& a, auto& b) {
                      return a.first > b.first ||
                             (a.first == b.first && *a.second < *b.second);
                    });
  BeamMap pruned;
  pruned.reserve(w);
  for (int i = 0; i < w; ++i) pruned.emplace(*scored[i].second,
                                             next[*scored[i].second]);
  beams = std::move(pruned);
}

// Best beam with the final in-progress word closed against the LM.
// ``out_frames`` (optional) receives the winner's per-char emission
// frames.
void best_beam(const BeamMap& beams, const DecodeConfig& cfg, const Lm* lm,
               const std::vector<std::string>& labels,
               std::vector<int>* out_ids, float* out_score,
               std::vector<int>* out_frames = nullptr) {
  float best = kNeg;
  const Beam* best_beam_ptr = nullptr;
  const std::vector<int>* best_prefix = nullptr;
  for (auto& kv : beams) {
    float total = kv.second.total();
    if (lm && cfg.space >= 0) {
      std::string w = last_word(kv.first, cfg.space, labels);
      if (!w.empty()) {
        auto ctx = context_words(kv.first, cfg.space, labels);
        total += cfg.alpha * lm->score(ctx, token_hash(w)) + cfg.beta;
      }
    }
    if (total > best ||
        (total == best && best_prefix && kv.first < *best_prefix)) {
      best = total;
      best_prefix = &kv.first;
      best_beam_ptr = &kv.second;
    }
  }
  if (best_prefix) *out_ids = *best_prefix;
  if (out_frames && best_beam_ptr) *out_frames = best_beam_ptr->frames;
  *out_score = best;
}

void decode_one(const float* logprobs, int T, int C, const DecodeConfig& cfg,
                const Lm* lm, const std::vector<std::string>& labels,
                std::vector<int>* out_ids, float* out_score,
                std::vector<int>* out_frames = nullptr) {
  BeamMap beams = beams_init();
  std::vector<int> cand(C);
  for (int t = 0; t < T; ++t)
    advance(beams, logprobs + (size_t)t * C, C, cfg, lm, labels, cand, t);
  best_beam(beams, cfg, lm, labels, out_ids, out_score, out_frames);
}

// All live beams, finalized (partial word closed against the LM) and
// sorted best-first — ctcdecode returns every beam, not just the top.
struct FinalBeam {
  const std::vector<int>* prefix;
  const std::vector<int>* frames;
  float total;
};

std::vector<FinalBeam> finalized_beams(const BeamMap& beams,
                                       const DecodeConfig& cfg,
                                       const Lm* lm,
                                       const std::vector<std::string>& labels) {
  std::vector<FinalBeam> out;
  out.reserve(beams.size());
  for (auto& kv : beams) {
    float total = kv.second.total();
    if (lm && cfg.space >= 0) {
      std::string w = last_word(kv.first, cfg.space, labels);
      if (!w.empty()) {
        auto ctx = context_words(kv.first, cfg.space, labels);
        total += cfg.alpha * lm->score(ctx, token_hash(w)) + cfg.beta;
      }
    }
    out.push_back({&kv.first, &kv.second.frames, total});
  }
  std::sort(out.begin(), out.end(),
            [](const FinalBeam& a, const FinalBeam& b) {
              return a.total > b.total ||
                     (a.total == b.total && *a.prefix < *b.prefix);
            });
  return out;
}

// Incremental beam session for live streams (tpuasr_torch.stream): the beam
// map persists across feed() calls; prefix() reports the stable common
// prefix of every live beam (what streaming may commit); best()
// finalizes. One session per stream; not thread-safe (the serving
// layer holds one lock around ticks).
struct BeamSession {
  DecodeConfig cfg;
  const Lm* lm = nullptr;  // borrowed from tpuasr_lm_load
  std::vector<std::string> labels;
  BeamMap beams = beams_init();
  std::vector<int> cand;
  int t_abs = 0;  // absolute frame counter (rows fed so far) — the
                  // emission-frame base; streams feed rows contiguously
                  // from frame 0, so this IS the conv-frame offset.
};

}  // namespace

extern "C" {

void* tpuasr_lm_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "TPUASRLM", 8)) {
    std::fclose(f);
    return nullptr;
  }
  auto* lm = new Lm();
  lm->unk_hash = token_hash("<unk>");
  uint32_t order = 0;
  if (std::fread(&order, 4, 1, f) != 1) { std::fclose(f); delete lm; return nullptr; }
  lm->order = (int)order;
  lm->tables.resize(order);
  for (uint32_t k = 0; k < order; ++k) {
    uint64_t cap = 0;
    if (std::fread(&cap, 8, 1, f) != 1) { std::fclose(f); delete lm; return nullptr; }
    auto& t = lm->tables[k];
    t.keys.resize(cap);
    t.logp.resize(cap);
    t.backoff.resize(cap);
    if (std::fread(t.keys.data(), 8, cap, f) != cap ||
        std::fread(t.logp.data(), 4, cap, f) != cap ||
        std::fread(t.backoff.data(), 4, cap, f) != cap) {
      std::fclose(f);
      delete lm;
      return nullptr;
    }
  }
  std::fclose(f);
  return lm;
}

void tpuasr_lm_free(void* lm) { delete static_cast<Lm*>(lm); }

// ABI version guard for the ctypes loader: bumped whenever an exported
// signature changes (v2: per-char emission frames in batch + session
// readouts; v3: n-best batch decode). A stale .so must never be
// dlopened against newer argtypes.
int tpuasr_abi_version() { return 3; }

// n-best batch decode (ctcdecode's full output): per utterance the
// top-n finalized beams, best-first. out_ids/out_frames are
// (B, n_best, T); out_lens/out_scores are (B, n_best). Rows past the
// number of live beams get len 0 / score -1e30.
int tpuasr_beam_decode_batch_nbest(
    const float* logprobs, const int* lengths, int B, int T, int C,
    const char* const* labels, int blank, int space, int beam_width,
    void* lm_handle, float alpha, float beta, int cutoff_top_n,
    float cutoff_prob, float prune_logp, int num_threads, int n_best,
    int* out_ids, int* out_frames, int* out_lens, float* out_scores) {
  std::vector<std::string> lab(C);
  for (int i = 0; i < C; ++i) lab[i] = labels[i];
  const Lm* lm = static_cast<const Lm*>(lm_handle);
  DecodeConfig cfg;
  cfg.blank = blank;
  cfg.space = space;
  cfg.beam_width = beam_width;
  cfg.alpha = alpha;
  cfg.beta = beta;
  cfg.cutoff_top_n = cutoff_top_n;
  cfg.cutoff_prob = cutoff_prob;
  cfg.prune_logp = prune_logp;

  auto work = [&](int b) {
    BeamMap beams = beams_init();
    std::vector<int> cand(C);
    const float* lp = logprobs + (size_t)b * T * C;
    for (int t = 0; t < lengths[b]; ++t)
      advance(beams, lp + (size_t)t * C, C, cfg, lm, lab, cand, t);
    auto ranked = finalized_beams(beams, cfg, lm, lab);
    for (int j = 0; j < n_best; ++j) {
      size_t base = ((size_t)b * n_best + j) * T;
      if (j < (int)ranked.size()) {
        const auto& fb = ranked[j];
        int n = std::min<int>((int)fb.prefix->size(), T);
        std::copy(fb.prefix->begin(), fb.prefix->begin() + n,
                  out_ids + base);
        if (out_frames) {
          int nf = std::min<int>((int)fb.frames->size(), n);
          std::copy(fb.frames->begin(), fb.frames->begin() + nf,
                    out_frames + base);
        }
        out_lens[(size_t)b * n_best + j] = n;
        out_scores[(size_t)b * n_best + j] = fb.total;
      } else {
        out_lens[(size_t)b * n_best + j] = 0;
        out_scores[(size_t)b * n_best + j] = kNeg;
      }
    }
  };

  if (num_threads <= 1) {
    for (int b = 0; b < B; ++b) work(b);
  } else {
    std::vector<std::thread> pool;
    std::atomic<int> cursor{0};
    for (int i = 0; i < num_threads; ++i)
      pool.emplace_back([&]() {
        int b;
        while ((b = cursor.fetch_add(1)) < B) work(b);
      });
    for (auto& th : pool) th.join();
  }
  return 0;
}

// labels: C UTF-8 strings (the alphabet). Returns 0 on success.
// out_frames (B x T) receives each character's emission frame
// (ctcdecode's "timesteps" output); pass nullptr to skip.
int tpuasr_beam_decode_batch(
    const float* logprobs, const int* lengths, int B, int T, int C,
    const char* const* labels, int blank, int space, int beam_width,
    void* lm_handle, float alpha, float beta, int cutoff_top_n,
    float cutoff_prob, float prune_logp, int num_threads,
    int* out_ids /*B x T*/, int* out_frames /*B x T or null*/,
    int* out_lens /*B*/, float* out_scores /*B*/) {
  std::vector<std::string> lab(C);
  for (int i = 0; i < C; ++i) lab[i] = labels[i];
  const Lm* lm = static_cast<const Lm*>(lm_handle);
  DecodeConfig cfg;
  cfg.blank = blank;
  cfg.space = space;
  cfg.beam_width = beam_width;
  cfg.alpha = alpha;
  cfg.beta = beta;
  cfg.cutoff_top_n = cutoff_top_n;
  cfg.cutoff_prob = cutoff_prob;
  cfg.prune_logp = prune_logp;

  auto work = [&](int b) {
    std::vector<int> ids, frames;
    float score = kNeg;
    decode_one(logprobs + (size_t)b * T * C, lengths[b], C, cfg, lm, lab,
               &ids, &score, out_frames ? &frames : nullptr);
    int n = std::min<int>((int)ids.size(), T);
    std::copy(ids.begin(), ids.begin() + n, out_ids + (size_t)b * T);
    if (out_frames)
      std::copy(frames.begin(), frames.begin() + n,
                out_frames + (size_t)b * T);
    out_lens[b] = n;
    out_scores[b] = score;
  };

  if (num_threads <= 1) {
    for (int b = 0; b < B; ++b) work(b);
  } else {
    std::vector<std::thread> pool;
    std::atomic<int> cursor{0};
    for (int i = 0; i < num_threads; ++i)
      pool.emplace_back([&]() {
        int b;
        while ((b = cursor.fetch_add(1)) < B) work(b);
      });
    for (auto& th : pool) th.join();
  }
  return 0;
}

// ---- incremental beam sessions (streaming serving) ----

void* tpuasr_beam_session_new(const char* const* labels, int C, int blank,
                              int space, int beam_width, void* lm_handle,
                              float alpha, float beta, int cutoff_top_n,
                              float cutoff_prob, float prune_logp) {
  auto* s = new BeamSession();
  s->labels.resize(C);
  for (int i = 0; i < C; ++i) s->labels[i] = labels[i];
  s->lm = static_cast<const Lm*>(lm_handle);
  s->cfg.blank = blank;
  s->cfg.space = space;
  s->cfg.beam_width = beam_width;
  s->cfg.alpha = alpha;
  s->cfg.beta = beta;
  s->cfg.cutoff_top_n = cutoff_top_n;
  s->cfg.cutoff_prob = cutoff_prob;
  s->cfg.prune_logp = prune_logp;
  s->cand.resize(C);
  return s;
}

void tpuasr_beam_session_free(void* s) { delete static_cast<BeamSession*>(s); }

void tpuasr_beam_session_reset(void* s) {
  auto* sess = static_cast<BeamSession*>(s);
  sess->beams = beams_init();
  sess->t_abs = 0;
}

// feed R rows of (C,) log-probabilities
void tpuasr_beam_session_feed(void* sp, const float* logprobs, int R) {
  auto* s = static_cast<BeamSession*>(sp);
  int C = (int)s->labels.size();
  for (int r = 0; r < R; ++r)
    advance(s->beams, logprobs + (size_t)r * C, C, s->cfg, s->lm, s->labels,
            s->cand, s->t_abs++);
}

// stable common prefix of every live beam; returns its length (<= cap).
// out_frames (optional) receives the BEST-scoring beam's emission
// frames for the prefix chars (beams agree on the prefix ids but may
// carry different alignments; the best beam's is the representative —
// same convention as the device kernel's dominant alignment).
int tpuasr_beam_session_prefix(void* sp, int* out, int* out_frames,
                               int cap) {
  auto* s = static_cast<BeamSession*>(sp);
  const std::vector<int>* lcp = nullptr;
  size_t n = 0;
  float best = kNeg;
  const Beam* best_b = nullptr;
  const std::vector<int>* best_p = nullptr;
  for (auto& kv : s->beams) {
    float tot = kv.second.total();
    if (tot > best || (tot == best && best_p && kv.first < *best_p)) {
      best = tot;
      best_b = &kv.second;
      best_p = &kv.first;
    }
    if (!lcp) {
      lcp = &kv.first;
      n = kv.first.size();
      continue;
    }
    size_t m = 0;
    size_t lim = std::min(n, kv.first.size());
    while (m < lim && (*lcp)[m] == kv.first[m]) ++m;
    n = m;
  }
  if (!lcp) return 0;
  int k = (int)std::min<size_t>(n, (size_t)cap);
  std::copy(lcp->begin(), lcp->begin() + k, out);
  if (out_frames && best_b) {
    int kf = (int)std::min<size_t>((size_t)k, best_b->frames.size());
    std::copy(best_b->frames.begin(), best_b->frames.begin() + kf,
              out_frames);
    for (int i = kf; i < k; ++i) out_frames[i] = -1;
  }
  return k;
}

// finalized best beam (last partial word closed against the LM);
// returns its length (<= cap). out_frames optional as above.
int tpuasr_beam_session_best(void* sp, int* out, int* out_frames, int cap,
                             float* score) {
  auto* s = static_cast<BeamSession*>(sp);
  std::vector<int> ids, frames;
  float sc = kNeg;
  best_beam(s->beams, s->cfg, s->lm, s->labels, &ids, &sc,
            out_frames ? &frames : nullptr);
  int k = (int)std::min<size_t>(ids.size(), (size_t)cap);
  std::copy(ids.begin(), ids.begin() + k, out);
  if (out_frames)
    std::copy(frames.begin(), frames.begin() + k, out_frames);
  if (score) *score = sc;
  return k;
}

// Levenshtein distance over int32 token sequences (the reference used
// the python-Levenshtein C extension for WER/CER, ref:decoder.py /
// SURVEY.md 3.2; tpuasr_torch.decode.metrics calls this when the lib
// builds and falls back to vectorized NumPy otherwise).
int32_t tpuasr_edit_distance(const int32_t* a, int32_t na,
                             const int32_t* b, int32_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  std::vector<int32_t> prev(nb + 1), cur(nb + 1);
  for (int32_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int32_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const int32_t ai = a[i - 1];
    for (int32_t j = 1; j <= nb; ++j) {
      int32_t best = prev[j - 1] + (ai != b[j - 1]);
      int32_t del = prev[j] + 1;
      int32_t ins = cur[j - 1] + 1;
      if (del < best) best = del;
      if (ins < best) best = ins;
      cur[j] = best;
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}
}
