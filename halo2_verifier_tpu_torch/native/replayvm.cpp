// Replay VM: executes a per-vk traced verifier program over proof batches.
//
// The Python tracer (protocol/trace.py) compiles
// `verify_proof` (reference: lib.rs:33-425) for a fixed vk into a flat tape
// of transcript interactions and Fr field ops; this VM runs that tape per
// proof — Blake2b/Keccak Fiat-Shamir hashing, G1 decompression, Montgomery
// arithmetic — and exports each proof's DualMSM scalars and points. Proofs
// are independent, so the batch splits across threads.
//
// Program buffer layout (trace.py ReplayProgram.serialize):
//   u32 header[8]: n_ops, n_regs, n_points, n_aux, n_consts, n_out,
//                  hash_kind (0=blake2b, 1=keccak256), min_proof_len
//   u32 out_regs[n_out]
//   u32 ops[n_ops][4]: opcode, a, b, c
//   u8  consts[n_consts][32]: canonical LE Fr
//
// Per-proof outputs: out_scalars n_out*32B canonical LE, out_points
// n_points*64B canonical LE (x||y), status 0 ok / 1 invalid (malformed
// proof stream: bad point encoding, non-canonical scalar, short proof, or
// an inversion of zero).
//
// Optional timing: for one proof in every kTimingEvery, the VM reads the
// clock where the tape's op class changes (hash, point, field) and sums
// the nanoseconds per class over the batch's threads. The other proofs,
// and every proof when the caller passes no timings buffer, read no clock.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "bn254_core.h"

extern "C" {
void h2v_keccak_f1600(uint64_t state[25]);
}

namespace {

using namespace h2v;

// ------------------------------------------------------------- Blake2b-512
// RFC 7693, sequential mode, 16-byte personalization "Halo2-Transcript"
// (matching hashlib.blake2b(digest_size=64, person=...) used by the Python
// transcript and the reference's blake2b_simd params, transcript/mod.rs).

constexpr u64 kBlakeIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline u64 rotr64(u64 x, unsigned n) { return (x >> n) | (x << (64 - n)); }

struct Blake2b {
  u64 h[8];
  u64 t;                // bytes compressed so far
  uint8_t buf[128];
  size_t buflen;

  void init(const uint8_t person[16]) {
    uint8_t param[64];
    std::memset(param, 0, sizeof(param));
    param[0] = 64;  // digest_length
    param[2] = 1;   // fanout
    param[3] = 1;   // depth
    std::memcpy(param + 48, person, 16);
    for (int i = 0; i < 8; ++i) {
      u64 p;
      std::memcpy(&p, param + 8 * i, 8);
      h[i] = kBlakeIV[i] ^ p;
    }
    t = 0;
    buflen = 0;
  }

  void compress(const uint8_t block[128], u64 t_total, bool last) {
    u64 m[16];
    for (int i = 0; i < 16; ++i) std::memcpy(&m[i], block + 8 * i, 8);
    u64 v[16];
    std::memcpy(v, h, 64);
    std::memcpy(v + 8, kBlakeIV, 64);
    v[12] ^= t_total;  // t low (messages < 2^64 bytes)
    if (last) v[14] = ~v[14];
    auto G = [&](int a, int b, int c, int d, u64 x, u64 y) {
      v[a] = v[a] + v[b] + x;
      v[d] = rotr64(v[d] ^ v[a], 32);
      v[c] = v[c] + v[d];
      v[b] = rotr64(v[b] ^ v[c], 24);
      v[a] = v[a] + v[b] + y;
      v[d] = rotr64(v[d] ^ v[a], 16);
      v[c] = v[c] + v[d];
      v[b] = rotr64(v[b] ^ v[c], 63);
    };
    for (int r = 0; r < 12; ++r) {
      const uint8_t* s = kSigma[r];
      G(0, 4, 8, 12, m[s[0]], m[s[1]]);
      G(1, 5, 9, 13, m[s[2]], m[s[3]]);
      G(2, 6, 10, 14, m[s[4]], m[s[5]]);
      G(3, 7, 11, 15, m[s[6]], m[s[7]]);
      G(0, 5, 10, 15, m[s[8]], m[s[9]]);
      G(1, 6, 11, 12, m[s[10]], m[s[11]]);
      G(2, 7, 8, 13, m[s[12]], m[s[13]]);
      G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
  }

  void update(const uint8_t* data, size_t n) {
    while (n) {
      if (buflen == 128) {  // full block held back until more data arrives
        t += 128;
        compress(buf, t, false);
        buflen = 0;
      }
      size_t take = 128 - buflen;
      if (take > n) take = n;
      std::memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      n -= take;
    }
  }

  // finalize a COPY (squeeze semantics: clone state + finalize,
  // transcript/mod.rs:209-214)
  void final64(uint8_t out[64]) const {
    Blake2b c = *this;
    uint8_t block[128];
    std::memset(block, 0, sizeof(block));
    std::memcpy(block, c.buf, c.buflen);
    c.t += c.buflen;
    c.compress(block, c.t, true);
    std::memcpy(out, c.h, 64);
  }
};

// -------------------------------------------------------------- Keccak-256
// Legacy Keccak (0x01 padding) sponge; EVM-compatible transcript
// (transcript/mod.rs:239-254).

struct KeccakT {
  u64 s[25];
  uint8_t buf[136];
  size_t buflen;

  void init() {
    std::memset(s, 0, sizeof(s));
    buflen = 0;
  }

  void update(const uint8_t* data, size_t n) {
    while (n) {
      size_t take = 136 - buflen;
      if (take > n) take = n;
      std::memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      n -= take;
      if (buflen == 136) {
        for (int i = 0; i < 17; ++i) {
          u64 lane;
          std::memcpy(&lane, buf + 8 * i, 8);
          s[i] ^= lane;
        }
        h2v_keccak_f1600(s);
        buflen = 0;
      }
    }
  }

  // finalize a copy with one extra byte absorbed (the lo/hi domain byte)
  void digest32_with(uint8_t extra, uint8_t out[32]) const {
    KeccakT c = *this;
    c.update(&extra, 1);
    u64 st[25];
    std::memcpy(st, c.s, sizeof(st));
    uint8_t block[136];
    std::memset(block, 0, sizeof(block));
    std::memcpy(block, c.buf, c.buflen);
    block[c.buflen] ^= 0x01;
    block[135] ^= 0x80;
    for (int i = 0; i < 17; ++i) {
      u64 lane;
      std::memcpy(&lane, block + 8 * i, 8);
      st[i] ^= lane;
    }
    h2v_keccak_f1600(st);
    std::memcpy(out, st, 32);
  }
};

// ------------------------------------------------------------- transcript

constexpr uint8_t kPrefixChallenge = 0x00;
constexpr uint8_t kPrefixPoint = 0x01;
constexpr uint8_t kPrefixScalar = 0x02;
constexpr uint8_t kKeccakLo = 0x0a;
constexpr uint8_t kKeccakHi = 0x0b;

// value of 64 uniform LE bytes mod R, output in Montgomery form
// (Challenge255, transcript/mod.rs:494-515)
void challenge255_mont(const uint8_t digest[64], u64 out[4]) {
  u64 lo[4], hi[4];
  std::memcpy(lo, digest, 32);
  std::memcpy(hi, digest + 32, 32);
  while (geq(lo, kFr.mod)) sub_raw(lo, kFr.mod);   // < 2^256 < 6R
  while (geq(hi, kFr.mod)) sub_raw(hi, kFr.mod);
  u64 hi_shift[4];
  to_mont(hi_shift, hi, kFr);  // = hi * 2^256 mod R (canonical value)
  u64 v[4];
  add_mod(v, lo, hi_shift, kFr);
  to_mont(out, v, kFr);
}

struct Transcript {
  int kind;  // 0 blake2b, 1 keccak256
  Blake2b b;
  KeccakT k;

  void init(int kind_) {
    kind = kind_;
    const uint8_t person[17] = "Halo2-Transcript";
    if (kind == 0) {
      b.init(person);
    } else {
      k.init();
      k.update(person, 16);
    }
  }

  void absorb(const uint8_t* data, size_t n) {
    if (kind == 0)
      b.update(data, n);
    else
      k.update(data, n);
  }

  void squeeze_challenge(u64 out_mont[4]) {
    absorb(&kPrefixChallenge, 1);
    uint8_t digest[64];
    if (kind == 0) {
      b.final64(digest);
    } else {
      k.digest32_with(kKeccakLo, digest);
      k.digest32_with(kKeccakHi, digest + 32);
    }
    challenge255_mont(digest, out_mont);
  }
};

// -------------------------------------------------------- G1 decompression
// halo2curves compressed codec: x LE with sign bit = top bit of byte 31
// (same path as h2v_g1_decompress_batch in bn254.cpp). Returns false on
// identity or invalid encoding — the transcript cannot absorb infinity
// (transcript/mod.rs:216-224), so both fail the proof.

// External-y variant: y0 (canonical LE) was computed off-host (the device
// sqrt pre-pass, ops/decomp.py) as rhs^((q+1)/4) for rhs = x^3 + 3.
// The VM re-checks y0^2 == rhs (so a wrong/garbage y0 or a non-residue rhs
// rejects exactly like the sqrt path) and applies the sign bit — ~5 mont
// muls instead of a ~381-mul Fermat sqrt.
bool check_point_ext(const uint8_t src[32], const uint8_t* y_ext,
                     uint8_t out_xy[64]) {
  uint8_t xbuf[32];
  std::memcpy(xbuf, src, 32);
  int ysign = (xbuf[31] >> 7) & 1;
  xbuf[31] &= 0x7f;
  u64 x[4];
  load_le(x, xbuf);
  if (is_zero4(x)) return false;
  if (geq(x, kFq.mod)) return false;
  u64 ye[4];
  load_le(ye, y_ext);
  if (geq(ye, kFq.mod)) return false;
  u64 xm[4], x2[4], rhs[4], ym[4], y2[4];
  to_mont(xm, x, kFq);
  mont_mul(x2, xm, xm, kFq);
  mont_mul(rhs, x2, xm, kFq);
  add_mod(rhs, rhs, kBMont, kFq);
  to_mont(ym, ye, kFq);
  mont_mul(y2, ym, ym, kFq);
  if (std::memcmp(y2, rhs, 32) != 0) return false;
  u64 yc[4];
  std::memcpy(yc, ye, 32);
  if ((int)(yc[0] & 1) != ysign) {
    u64 neg[4];
    std::memcpy(neg, kFq.mod, 32);
    sub_raw(neg, yc);
    std::memcpy(yc, neg, 32);
  }
  store_le(out_xy, x);
  store_le(out_xy + 32, yc);
  return true;
}

bool decompress_point(const uint8_t src[32], uint8_t out_xy[64]) {
  uint8_t xbuf[32];
  std::memcpy(xbuf, src, 32);
  int ysign = (xbuf[31] >> 7) & 1;
  xbuf[31] &= 0x7f;
  u64 x[4];
  load_le(x, xbuf);
  if (is_zero4(x)) return false;  // identity (or x=0: not on curve)
  if (geq(x, kFq.mod)) return false;
  u64 xm[4], x2[4], rhs[4], y[4], y2[4];
  to_mont(xm, x, kFq);
  mont_mul(x2, xm, xm, kFq);
  mont_mul(rhs, x2, xm, kFq);
  add_mod(rhs, rhs, kBMont, kFq);
  mont_pow(y, rhs, kFqSqrtExp, 4, kFq);
  mont_mul(y2, y, y, kFq);
  if (std::memcmp(y2, rhs, 32) != 0) return false;
  u64 yc[4];
  from_mont(yc, y, kFq);
  if ((int)(yc[0] & 1) != ysign) {
    u64 neg[4];
    std::memcpy(neg, kFq.mod, 32);
    sub_raw(neg, yc);
    std::memcpy(yc, neg, 32);
  }
  store_le(out_xy, x);
  store_le(out_xy + 32, yc);
  return true;
}

// --------------------------------------------------------------------- VM

enum Op : uint32_t {
  OP_END = 0,
  OP_CONST = 1,
  OP_ADD = 2,
  OP_SUB = 3,
  OP_MUL = 4,
  OP_NEG = 5,
  OP_INV = 6,
  OP_SQUEEZE = 7,
  OP_READ_SCALAR = 8,
  OP_READ_POINT = 9,
  OP_ABSORB_REG = 10,
  OP_AUX_LOAD = 11,
  OP_BATCH_INV = 12,
};

// Op classes of the sampled timing, in the order of the timings buffer.
enum OpClass : int { CLS_HASH = 0, CLS_POINT = 1, CLS_FIELD = 2 };
constexpr uint64_t kTimingEvery = 8;

// hash: the transcript's absorb and squeeze work (OP_READ_POINT's absorb
// too); point: OP_READ_POINT's decoding and curve check; field: the rest.
inline int op_class(uint32_t code) {
  switch (code) {
    case OP_SQUEEZE:
    case OP_READ_SCALAR:
    case OP_ABSORB_REG:
      return CLS_HASH;
    case OP_READ_POINT:
      return CLS_POINT;
    default:
      return CLS_FIELD;
  }
}

inline u64 now_ns() {
  return (u64)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Nanoseconds per op class along one proof's tape; the clock is read only
// where the class changes.
struct ClassClock {
  u64 ns[3] = {0, 0, 0};
  int cur = CLS_HASH;
  u64 t = 0;

  void start(int c) {
    cur = c;
    t = now_ns();
  }
  void to(int c) {
    if (c == cur) return;
    u64 n = now_ns();
    ns[cur] += n - t;
    t = n;
    cur = c;
  }
  void stop() { ns[cur] += now_ns() - t; }
};

struct Program {
  uint32_t n_ops, n_regs, n_points, n_aux, n_consts, n_out, hash_kind,
      min_proof_len;
  const uint32_t* out_regs;
  const uint32_t* ops;          // n_ops * 4
  std::vector<u64> consts_mont;  // n_consts * 4 limbs

  bool parse(const uint8_t* buf) {
    uint32_t hdr[8];
    std::memcpy(hdr, buf, 32);
    n_ops = hdr[0];
    n_regs = hdr[1];
    n_points = hdr[2];
    n_aux = hdr[3];
    n_consts = hdr[4];
    n_out = hdr[5];
    hash_kind = hdr[6];
    min_proof_len = hdr[7];
    out_regs = reinterpret_cast<const uint32_t*>(buf + 32);
    ops = out_regs + n_out;
    const uint8_t* cb = reinterpret_cast<const uint8_t*>(ops + 4 * n_ops);
    consts_mont.resize(4 * n_consts);
    for (uint32_t i = 0; i < n_consts; ++i) {
      u64 c[4];
      load_le(c, cb + 32 * i);
      to_mont(&consts_mont[4 * i], c, kFr);
    }
    return true;
  }
};

// returns 0 ok, 1 invalid. weight_mont (optional): all exported scalars
// are multiplied by it — the AccumulatorStrategy's per-proof random
// isolation weight (kzg/strategy.rs:129), folded in here so the host never
// touches per-entry big ints. kTimed: `clk`, started by the caller in
// CLS_HASH, follows the tape's op classes (the caller stops it).
template <bool kTimed>
int run_one(const Program& p, const uint8_t* proof, u64 proof_len,
            const uint8_t* aux, const u64* weight_mont, u64* regs,
            uint8_t* out_scalars, uint8_t* out_points,
            const uint8_t* ext_y, ClassClock* clk) {
  Transcript tr;
  tr.init((int)p.hash_kind);
  u64 cursor = 0;
  uint8_t tmp[65];

  for (uint32_t i = 0; i < p.n_ops; ++i) {
    const uint32_t* op = p.ops + 4 * i;
    u64* dst = regs + 4 * op[1];
    if constexpr (kTimed) clk->to(op_class(op[0]));
    switch (op[0]) {
      case OP_END:
        goto done;
      case OP_CONST:
        std::memcpy(dst, &p.consts_mont[4 * op[2]], 32);
        break;
      case OP_ADD:
        add_mod(dst, regs + 4 * op[2], regs + 4 * op[3], kFr);
        break;
      case OP_SUB:
        sub_mod(dst, regs + 4 * op[2], regs + 4 * op[3], kFr);
        break;
      case OP_MUL:
        mont_mul(dst, regs + 4 * op[2], regs + 4 * op[3], kFr);
        break;
      case OP_NEG: {
        const u64* a = regs + 4 * op[2];
        if (is_zero4(a)) {
          std::memset(dst, 0, 32);
        } else {
          u64 t[4];
          std::memcpy(t, kFr.mod, 32);
          sub_raw(t, a);
          std::memcpy(dst, t, 32);
        }
        break;
      }
      case OP_INV: {
        const u64* a = regs + 4 * op[2];
        if (is_zero4(a)) return 1;  // pow(0, -1, R) raises in the oracle
        mont_pow(dst, a, kFrInvExp, 4, kFr);
        break;
      }
      case OP_BATCH_INV: {
        // k consecutive ops form the group (first carries k in c); one
        // Fermat pow + 3(k-1) muls via Montgomery's trick
        uint32_t k = op[3];
        if (k == 0 || i + k > p.n_ops) return 1;
        u64 prefix[64][4];  // running products; verifier groups are small
        if (k > 64) return 1;
        for (uint32_t j = 0; j < k; ++j) {
          const u64* a = regs + 4 * p.ops[4 * (i + j) + 2];
          if (is_zero4(a)) return 1;
          if (j == 0)
            std::memcpy(prefix[0], a, 32);
          else
            mont_mul(prefix[j], prefix[j - 1], a, kFr);
        }
        u64 inv_run[4];
        mont_pow(inv_run, prefix[k - 1], kFrInvExp, 4, kFr);
        for (uint32_t j = k; j-- > 0;) {
          u64* d = regs + 4 * p.ops[4 * (i + j) + 1];
          const u64* a = regs + 4 * p.ops[4 * (i + j) + 2];
          if (j == 0) {
            std::memcpy(d, inv_run, 32);
          } else {
            u64 next[4];
            mont_mul(next, inv_run, a, kFr);  // inv of prefix[j-1]
            mont_mul(d, inv_run, prefix[j - 1], kFr);
            std::memcpy(inv_run, next, 32);
          }
        }
        i += k - 1;
        break;
      }
      case OP_SQUEEZE:
        tr.squeeze_challenge(dst);
        break;
      case OP_READ_SCALAR: {
        if (cursor + 32 > proof_len) return 1;
        u64 v[4];
        load_le(v, proof + cursor);
        if (geq(v, kFr.mod)) return 1;  // from_repr rejects >= R
        tmp[0] = kPrefixScalar;
        std::memcpy(tmp + 1, proof + cursor, 32);
        tr.absorb(tmp, 33);
        cursor += 32;
        to_mont(dst, v, kFr);
        break;
      }
      case OP_READ_POINT: {
        if (cursor + 32 > proof_len) return 1;
        uint8_t* xy = out_points + 64 * op[1];
        if (ext_y) {
          if (!check_point_ext(proof + cursor, ext_y + 32 * op[1], xy))
            return 1;
        } else if (!decompress_point(proof + cursor, xy)) {
          return 1;
        }
        if constexpr (kTimed) clk->to(CLS_HASH);
        cursor += 32;
        tmp[0] = kPrefixPoint;
        std::memcpy(tmp + 1, xy, 64);
        tr.absorb(tmp, 65);
        break;
      }
      case OP_ABSORB_REG: {
        u64 v[4];
        from_mont(v, regs + 4 * op[1], kFr);
        tmp[0] = kPrefixScalar;
        store_le(tmp + 1, v);
        tr.absorb(tmp, 33);
        break;
      }
      case OP_AUX_LOAD: {
        u64 v[4];
        load_le(v, aux + 32 * op[2]);
        to_mont(dst, v, kFr);
        break;
      }
      default:
        return 1;
    }
  }
done:
  if constexpr (kTimed) clk->to(CLS_FIELD);
  for (uint32_t i = 0; i < p.n_out; ++i) {
    u64 v[4];
    if (weight_mont) {
      u64 w[4];
      mont_mul(w, regs + 4 * p.out_regs[i], weight_mont, kFr);
      from_mont(v, w, kFr);
    } else {
      from_mont(v, regs + 4 * p.out_regs[i], kFr);
    }
    store_le(out_scalars + 32 * i, v);
  }
  return 0;
}

}  // namespace

extern "C" {

// Execute the program over n_proofs proofs. proofs: n * proof_stride bytes
// (per-proof length in proof_lens); aux: n * aux_stride bytes (32B canonical
// LE scalars, the instance values). Outputs per proof: out_scalars
// n_out*32B, out_points n_points*64B, status 1B. Returns number of invalid
// proofs, or -1 on a malformed program.
// ext_y (optional): n_proofs * n_points * 32B canonical LE principal roots
// of x^3+3 (device sqrt pre-pass) — READ_POINT then verifies y^2 == x^3+3
// and applies the sign bit instead of computing the Fermat sqrt itself.
// timings (optional): 4 u64, set to the nanoseconds, summed over threads,
// that the proofs i with i % kTimingEvery == 0 spent in op classes hash,
// point and field, and their whole run (the sum of the three).
int64_t h2v_replay_batch(const uint8_t* program_buf, const uint8_t* proofs,
                         uint64_t proof_stride, const uint64_t* proof_lens,
                         const uint8_t* aux, uint64_t aux_stride,
                         uint64_t n_proofs, const uint8_t* weights,
                         uint8_t* out_scalars, uint8_t* out_points,
                         uint8_t* status, int n_threads,
                         const uint8_t* ext_y, uint64_t* timings) {
  Program p;
  if (!p.parse(program_buf)) return -1;
  if (n_threads < 1) n_threads = 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw && (unsigned)n_threads > hw) n_threads = (int)hw;
  if ((u64)n_threads > n_proofs) n_threads = (int)(n_proofs ? n_proofs : 1);

  // per thread: ns of hash, point, field of its sampled proofs
  std::vector<ClassClock> clocks((size_t)n_threads);

  auto worker = [&](u64 lo, u64 hi, ClassClock* acc) {
    std::vector<u64> regs(4 * (size_t)p.n_regs);
    for (u64 i = lo; i < hi; ++i) {
      u64 wmont[4];
      const u64* wp = nullptr;
      if (weights) {
        u64 w[4];
        load_le(w, weights + 32 * i);
        to_mont(wmont, w, kFr);
        wp = wmont;
      }
      const uint8_t* proof = proofs + i * proof_stride;
      const uint8_t* a = aux + i * aux_stride;
      uint8_t* sc = out_scalars + i * (u64)p.n_out * 32;
      uint8_t* pt = out_points + i * (u64)p.n_points * 64;
      const uint8_t* ey = ext_y ? ext_y + i * (u64)p.n_points * 32 : nullptr;
      if (timings && i % kTimingEvery == 0) {
        ClassClock clk;
        clk.start(CLS_HASH);
        status[i] = (uint8_t)run_one<true>(p, proof, proof_lens[i], a, wp,
                                           regs.data(), sc, pt, ey, &clk);
        clk.stop();
        for (int c = 0; c < 3; ++c) acc->ns[c] += clk.ns[c];
      } else {
        status[i] = (uint8_t)run_one<false>(p, proof, proof_lens[i], a, wp,
                                            regs.data(), sc, pt, ey,
                                            nullptr);
      }
    }
  };

  if (n_threads == 1) {
    worker(0, n_proofs, &clocks[0]);
  } else {
    std::vector<std::thread> threads;
    u64 chunk = (n_proofs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      u64 lo = (u64)t * chunk;
      u64 hi = lo + chunk < n_proofs ? lo + chunk : n_proofs;
      if (lo >= hi) break;
      threads.emplace_back(worker, lo, hi, &clocks[(size_t)t]);
    }
    for (auto& th : threads) th.join();
  }

  if (timings) {
    std::memset(timings, 0, 4 * sizeof(uint64_t));
    for (const ClassClock& c : clocks)
      for (int k = 0; k < 3; ++k) timings[k] += c.ns[k];
    timings[3] = timings[0] + timings[1] + timings[2];
  }

  int64_t bad = 0;
  for (u64 i = 0; i < n_proofs; ++i) bad += status[i];
  return bad;
}

}  // extern "C"
