// K1, the whole-model kernel (csrc/fused_model.cu is its C entry and
// says what bounds it), redesigned for Hopper. Shared by the translation
// units fused_model_<form>_r<rows>.cu, one per form of X (1 or 2 digit
// planes; byte levels split into 1 or 2 digits on load; the offset-signed
// single-plane chain) and tile height, so that nvcc builds them in parallel.
//
// One thread-block cluster of cl CTAs per batch (ops/fused_model.py
// fused_model_plan); a CTA of RT = 128 rows (64 where 128 do not fit the
// shared memory) runs RT / 16 warps, each owning 16 rows of every tile, and
// CTA r owns the row tiles r, r + cl, ... of its batch. The levers, in the order of the chain's cost:
//   1. The aggregation's packed A through K2's loader (packmm_k2.cuh): a
//      cp.async.cg ring of 3 or 4 raw word stages, 64, 128 or 256 columns
//      deep (the plan's depth), runs stages - 2 steps ahead with one barrier a step,
//      one stream over all of a CTA's tiles and column passes, so a tile's
//      end overlaps the next tile's loads; the copy and fragment offsets are
//      fixed per thread and the step loop divides nothing. Each warp builds
//      its A fragments straight from the packed words in the slot (4
//      columns' words, a byte permute, a shift: no int8 A tile, no unpack
//      barrier). With a block schedule the ring walks the listed blocks.
//   2. The update's epilogue writes the hidden plane P transposed,
//      [nd][n][pn] (k-contiguous), so an aggregation's B tile is a plain
//      copy and its fragments come from ldmatrix with no byte transpose. It
//      streams through the ring beside A (staging a plane whole in shared
//      memory once per aggregation read within 3% of this on the card and
//      was dropped). GIN's first aggregation reads X row-major through the
//      ring and transposes it by 4 x 4 byte blocks.
//   3. The aggregation's rows stay in shared memory: a warp's 16 rows go
//      from the aggregation's epilogue into Q, and the same warp's update
//      reads them there (a warp reads only the rows it wrote, so no CTA
//      barrier). No global Q, no fence per tile: one __threadfence before
//      each cluster barrier. Each layer's weights are staged once per CTA,
//      transposed, before its aggregation.
// The signed chain's row sums (rs) come from the A fragments with __dp4a
// wherever they are built, so a block a schedule leaves out drops its
// product and its degree together. What binds a step on the card is still
// open (PERF.md section 7).
#pragma once

#include "async_cluster.cuh"
#include "gemm_core.cuh"

namespace qgtc {
namespace k1 {

constexpr int MAX_LAYERS = 8;   // ops/fused_model.py MAX_LAYERS
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int XCHUNK = 128;     // GCN's first update reads X in chunks of it
constexpr int NC = 64;          // columns per pass of a GEMM
constexpr int MAX_STAGES = 4;   // the deepest ring a plan may take

// How X arrives and which chain runs (ops/fused_model.py MegaPlan.form).
enum XForm {
  X_DIGITS = 0,  // [nd_x][pn][xp] base-16 digit planes; the digit chain
  X_SPLIT = 1,   // [1][pn][xp] byte levels, split into nd_x digit planes
                 // (low digit masked by x_lo, high by x_hi); the digit chain
  X_SIGNED = 2,  // [1][pn][xp] byte levels, loaded as level - 128; every
                 // operand one offset-signed plane (below)
};

// The offset-signed chain (X_SIGNED): X, every weight and every hidden
// layer is one int8 plane of level - 128, so each GEMM is one int8 pass,
// and a rank-1 correction restores the unsigned product exactly (sums in
// uint32, which wraps like the int32 algebra):
//   update  H W = Hs Ws + 128 rowsum(Hs) + corr[n],
//           corr = 128 colsum(Ws) + 128^2 K over the K rows contracted;
//   aggr.   A H = A Hs + 128 deg,
//           deg = the row's ones in the A blocks visited.
// Weight rows past a layer's input are level 0 (Ws = -128), so whatever
// Q or X holds there cancels.

struct Params {
  float* out;          // [B][pn][oc]
  const int32_t* a;    // [B][pn / 32][pn] M-packed 1-bit adjacency
  const int8_t* x;     // [B][nd_x][pn][xp] digits (X_DIGITS), else [B][1][pn][xp]
  const int8_t* w;     // layer l at byte w_off[l]: [nd_w][kp[l]][np[l]]
  const int* corr;     // X_SIGNED: layer l's corr[np[l]] at c_off[l]
  const int* sched;    // [B][pn / chunk][nj + 1] or null (dense)
  int8_t* scratch;     // [B][2][nd_h][hw][pn]: P0, P1 transposed
  int B, pn, xp, out_bits, oc, chunk, nj, hw, n_layers, gin, cl, stages, kd;
  uint32_t x_lo, x_hi;  // X_SPLIT: each byte's masks of its digits
  int kp[MAX_LAYERS], np[MAX_LAYERS], nw[MAX_LAYERS], w_off[MAX_LAYERS];
  int c_off[MAX_LAYERS];
  int shift[2 * MAX_LAYERS];
  // shared-memory layout (bytes), Layout below
  int slot, off_bs, off_q, qld, off_wt, off_pst, off_meta;
};

// The shared-memory layout of one launch; ops/fused_model.py _k1_smem
// takes the same sums. The front region holds the aggregation phase (ring,
// GIN's transposed X tiles) or GCN's first
// update (X's rows of each warp), whichever is larger; then Q, the
// layer's transposed weights, each warp's staging of P and each ring
// slot's step.
struct Layout {
  int slot, off_bs, off_q, qld, off_wt, off_pst, off_meta, total;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// nd_*: the signed chain's are 1. planes (n_planes widths): the hidden
// planes the aggregations read; qws: the widths left in Q; kins: each
// update's contraction.
inline Layout layout(int rows, int stages, int kd, int xp, bool gin, int nd_h, int nd_w, int nd_xm,
                     int nd_xd, const int* nw, int n) {
  Layout L{};
  const int lda = kd + 16;  // a k-contiguous tile's row stride
  const int n_planes = gin ? n - 1 : n;
  int slot_b = gin ? nd_xm * kd * NC : 0;
  if (n_planes > 0) slot_b = slot_b > nd_h * NC * lda ? slot_b : nd_h * NC * lda;
  L.slot = 8 * (4 * kd + 64) + slot_b;  // the step's words: 8 word rows x kd columns, then B
  L.off_bs = stages * L.slot;
  int front = L.off_bs + (gin ? 2 * nd_xd * NC * lda : 0);
  const int xt = gin ? 0 : nd_xd * rows * ((xp < XCHUNK ? xp : XCHUNK) + 16);
  front = front > xt ? front : xt;
  int qmax = gin ? xp : 0;
  for (int l = 0; l < n - 1; ++l) qmax = qmax > nw[l] ? qmax : nw[l];
  L.qld = round_up(qmax, 32) + 16;
  L.off_q = front;
  L.off_wt = L.off_q + (qmax ? nd_h * rows * L.qld : 0);
  int wt = 0;
  for (int l = 0; l < n; ++l) {
    const int k = l ? nw[l - 1] : xp;
    const int b = nd_w * nw[l] * (round_up(k, 32) + 16);
    wt = wt > b ? wt : b;
  }
  L.off_pst = L.off_wt + wt;
  L.off_meta = L.off_pst + (rows / 16) * nd_h * NC * 16;
  L.total = L.off_meta + 8 * MAX_STAGES * 4;  // each ring slot's step, 8 ints
  return L;
}

// ldmatrix .x4: four 8 x 16-byte matrices; lane l gives the row address
// of matrix l / 8, row l % 8, and gets, of each matrix, row l / 4, bytes
// 4 (l % 4) .. + 3: the int8 mma.m16n8k32 fragments of k-contiguous rows.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_u(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared address `dst`, bypassing L1.
__device__ __forceinline__ void cp_async16_u(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}


__device__ __forceinline__ uint32_t dp4(uint32_t v, uint32_t acc) {
  return (uint32_t)__dp4a((int)v, 0x01010101, (int)acc);
}

// The K steps one row tile's aggregation visits, kd columns each: the
// whole contraction, or the column blocks (cb wide, a multiple of 128) its
// schedule row [count, j_0, ...] lists, the last step of a block cut to
// what is left of it (an entry outside [0, nj) is skipped: memory safety
// only).
struct Steps {
  const int* srow;
  int cnt, nj, cb, kd, spb, pn;
  int t, s;  // cursor: listed block t, step s within it

  __device__ __forceinline__ Steps(const int* row, int nj_, int cb_, int pn_, int kd_)
      : srow(row), cnt(0), nj(nj_), cb(cb_), kd(kd_), spb((cb_ + kd_ - 1) / kd_), pn(pn_), t(0), s(0) {
    if (srow) {
      cnt = min(max(__ldg(srow), 0), nj);
      skip();
    }
  }
  __device__ __forceinline__ bool valid_j(int j) const { return j >= 0 && j < nj; }
  __device__ __forceinline__ void skip() {
#pragma unroll 1
    while (t < cnt && !valid_j(__ldg(srow + 1 + t))) ++t;
  }
  __device__ __forceinline__ int count() const {
    if (!srow) return pn / kd;
    int c = 0;
#pragma unroll 1
    for (int i = 0; i < cnt; ++i) c += valid_j(__ldg(srow + 1 + i));
    return c * spb;
  }
  // the current step's first column and depth; then advance
  __device__ __forceinline__ int next(int& kk) {
    int k0;
    if (!srow) {
      k0 = s * kd;
      kk = kd;
      ++s;
    } else {
      k0 = __ldg(srow + 1 + t) * cb + s * kd;
      kk = min(kd, cb - s * kd);
      if (++s == spb) {
        s = 0;
        ++t;
        skip();
      }
    }
    return k0;
  }
};

template <int XF, int ND_X, int ND_W, int ND_H, int RT>
struct Chain {
  static constexpr bool SG = XF == X_SIGNED;
  static constexpr int WARPS = RT / 16, NTHR = RT * 2;
  static constexpr int ND_XM = XF == X_DIGITS ? ND_X : 1;  // X's planes in memory
  static_assert(!SG || (ND_X == 1 && ND_W == 1 && ND_H == 1), "one plane per operand");
  static_assert(XF != X_DIGITS || ND_X <= 2, "1 or 2 digit planes");

  const Params& p;
  unsigned char* const sm;
  const int b, rank, tid, lane, warp, g, t4;
  int32_t const* abatch;  // this batch's packed words
  int8_t* pbase;          // this batch's P0; P1 follows
  size_t hplane;          // hw * pn: one digit plane of P

  __device__ Chain(const Params& pp, unsigned char* smem)
      : p(pp), sm(smem), b(blockIdx.x / pp.cl), rank(blockIdx.x % pp.cl), tid(threadIdx.x),
        lane(threadIdx.x & 31), warp(threadIdx.x >> 5), g((threadIdx.x & 31) >> 2),
        t4(threadIdx.x & 3) {
    abatch = p.a + (size_t)b * (p.pn / 32) * p.pn;
    hplane = (size_t)p.hw * p.pn;
    pbase = p.scratch + (size_t)b * 2 * ND_H * hplane;
  }

  __device__ __forceinline__ int8_t* P(int i) const { return pbase + (size_t)i * ND_H * hplane; }
  __device__ __forceinline__ int ntiles() const { return p.pn / RT; }
  __device__ __forceinline__ int wld(int k) const { return round_up(k, 32) + 16; }

  __device__ __forceinline__ void cluster_sync() const {
    __threadfence();  // P's rows reach L2 before the barrier
    cluster_barrier();
  }

  // Layer l's weights [nd_w][kp][np] -> shared W^T [nd_w][nw][wld(k)], its
  // K = round_up(k, 32) rows, by 4 x 4 byte blocks. The caller's next
  // barrier publishes it.
  __device__ void stage_weights(int l, int k) const {
    const int K = round_up(k, 32), nw = p.nw[l], ld = wld(k), np = p.np[l];
    const size_t plane = (size_t)p.kp[l] * np;
    int8_t* const wt = reinterpret_cast<int8_t*>(sm + p.off_wt);
    const int per = (K / 4) * (nw / 4);
    for (int i = tid; i < ND_W * per; i += NTHR) {
      const int e = i / per, r = i - e * per;
      const int kq = r / (nw / 4), nq = r - kq * (nw / 4);
      const int8_t* src = p.w + p.w_off[l] + e * plane + (size_t)(4 * kq) * np + 4 * nq;
      const uint32_t x0 = __ldg(reinterpret_cast<const uint32_t*>(src));
      const uint32_t x1 = __ldg(reinterpret_cast<const uint32_t*>(src + np));
      const uint32_t x2 = __ldg(reinterpret_cast<const uint32_t*>(src + 2 * np));
      const uint32_t x3 = __ldg(reinterpret_cast<const uint32_t*>(src + 3 * np));
      transpose4(wt + (size_t)e * nw * ld + (4 * nq) * ld + 4 * kq, ld, x0, x1, x2, x3);
    }
  }

  // Rows x0..x3 of a 4 x 4 byte block -> its columns, 4 bytes each, at dst,
  // dst + ld, ... (the block transposed).
  static __device__ __forceinline__ void transpose4(int8_t* dst, int ld, uint32_t x0, uint32_t x1,
                                                    uint32_t x2, uint32_t x3) {
    const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
    const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + ld) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * ld) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * ld) = __byte_perm(hi01, hi23, 0x7632);
  }

  // 4 bytes of X as the ND_X planes the chain multiplies.
  __device__ __forceinline__ void xbytes(uint32_t (&v)[ND_X], uint32_t raw) const {
    if constexpr (XF == X_SIGNED) {
      v[0] = raw ^ 0x80808080u;
    } else if constexpr (XF == X_SPLIT) {
      v[0] = raw & p.x_lo;
      if constexpr (ND_X == 2) v[1] = (raw >> 4) & p.x_hi;
    } else {
      v[0] = raw;  // X_DIGITS: one plane at a time (the caller's loop)
    }
  }

  // -- the aggregation ---------------------------------------------------

  // One aggregation over every row tile of this CTA: A x B over `width`
  // columns, in units of one tile and one 64-column pass (tile rank +
  // i cl, columns n0 = 64 c ..), as ONE stream of K steps through the ring,
  // so the next unit's loads are in flight while a unit ends. After a
  // unit's last step its rows go to Q (l >= 0) or to the logits (l < 0);
  // after a tile's last pass, layer l's update of its rows (Q -> P^T `dst`
  // or the logits). B, streamed beside A: X (XMODE, transposed), or the
  // hidden plane `bsrc` (P^T) of `width` columns. A unit that its schedule leaves empty
  // still ends: its outputs are the epilogue of zero sums. The step loop
  // divides nothing and recomputes no address: a step is a handful of
  // MMAs, and every warp runs its bookkeeping.
  template <int ND_B, bool XMODE>
  __device__ void aggregate(const int8_t* bsrc, int width, int shift, int l, int k, int8_t* dst,
                            int ushift) const {
    const int S = p.stages, cb = p.nj ? p.pn / p.nj : p.pn;
    // a slot: the 8 word rows of the step's words, a_ld bytes apart (4 kd
    // + 64: a warp's fragment loads, 2 word rows x 4 columns, fall in distinct
    // banks), then B
    const int kd = p.kd, lda = kd + 16, a_ld = 4 * kd + 64, a_raw = 8 * a_ld;
    const int lgq = __ffs(kd / 4) - 1;  // kd / 4 = 1 << lgq
    unsigned char* const ring = sm;
    const uint32_t ring_u = smem_u32(sm);
    int8_t* const Bs = reinterpret_cast<int8_t*>(sm + p.off_bs);  // [2][ND_B][NC][lda]
    // each slot's step: k0, m0, n0 | ntc << 16, unit, kk (written by the
    // issuing thread, read after the next barrier)
    int* const meta = reinterpret_cast<int*>(sm + p.off_meta);
    const int* const sbase = p.sched ? p.sched + (size_t)b * (p.pn / p.chunk) * (p.nj + 1) : nullptr;
    const int nch = (width + NC - 1) / NC;
    const int ntl = (ntiles() - rank + p.cl - 1) / p.cl, nunits = ntl * nch;
    auto srow_of = [&](int m0) { return sbase ? sbase + (m0 / p.chunk) * (p.nj + 1) : nullptr; };

    // -- the issue side: its unit (tile m0, columns n0, ntc n-tiles)
    int total = 0;
    for (int i = 0; i < ntl; ++i)
      total += nch * Steps(srow_of((rank + i * p.cl) * RT), p.nj, cb, p.pn, kd).count();
    int iu = 0, im0 = rank * RT, in0 = 0, intc = min(NC, width) / 8, islot = 0, issued = 0;
    Steps ic(srow_of(im0), p.nj, cb, p.pn, kd);
    int ileft = nunits ? ic.count() : 0;
    // A: a step's 2 kd 16-byte chunks (word row wr, columns kc .. kc + 3),
    // thread tid takes chunks tid, tid + NTHR, ...; the same ones it unpacks
    const int a_per = kd / 4;  // chunks of a word row
    const int32_t* a_src = abatch + (size_t)((im0 >> 8) * 8) * p.pn;
    auto issue = [&]() {
      while (ileft == 0) {  // the next unit with steps (one exists: issued < total)
        ++iu;
        in0 += NC;
        if (in0 >= width) {
          in0 = 0;
          im0 += p.cl * RT;
        }
        intc = min(NC, width - in0) / 8;
        ic = Steps(srow_of(im0), p.nj, cb, p.pn, kd);
        ileft = ic.count();
        a_src = abatch + (size_t)((im0 >> 8) * 8) * p.pn;
      }
      int kk;
      const int k0 = ic.next(kk);
      --ileft;
      if (tid == 0) {
        *reinterpret_cast<int4*>(meta + 8 * islot) = make_int4(k0, im0, in0 | (intc << 16), iu);
        meta[8 * islot + 4] = kk;
      }
      const uint32_t slot = ring_u + islot * p.slot;
      for (int c = tid; c < 2 * kd; c += NTHR) {  // word row wr: a_ld bytes apart in the slot
        const int wr = c >> lgq, kc = (c & (a_per - 1)) * 4;
        if (kc < kk) cp_async16_u(slot + wr * a_ld + kc * 4, a_src + (size_t)wr * p.pn + k0 + kc);
      }
      if constexpr (XMODE) {  // X's rows k0 .. k0 + kk: [e][k][NC] bytes
        const int per_k = intc / 2;  // 16-byte chunks of a row (8 ntc columns)
        for (int c = tid; c < ND_XM * kk * per_k; c += NTHR) {
          const int e = c / (kk * per_k), r = c - e * kk * per_k;
          const int kr = r / per_k, cc = (r - kr * per_k) * 16;
          cp_async16_u(slot + a_raw + (e * kd + kr) * NC + cc,
                       bsrc + (size_t)e * p.pn * p.xp + (size_t)(k0 + kr) * p.xp + in0 + cc);
        }
      } else {  // P^T's rows n0 .. at k0: [e][n][lda]
        const int q16 = kd / 16, rows = ND_B * intc * 8;  // a thread keeps its 16-byte column
        const int kc = (tid & (q16 - 1)) * 16;
        if (kc < kk)
          for (int r = tid / q16; r < rows; r += NTHR / q16) {
            const int e = r >= intc * 8, n = r - e * intc * 8;
            cp_async16_u(slot + a_raw + (e * NC + n) * lda + kc,
                         bsrc + e * hplane + (size_t)(in0 + n) * p.pn + k0 + kc);
          }
      }
      ++issued;
      if (++islot == S) islot = 0;
    };
    // X's raw rows in slot -> its transposed tile `buf`
    auto unpack = [&](int slot_i, int buf) {
      const unsigned char* const slot = ring + slot_i * p.slot;
      const int4 m = *reinterpret_cast<const int4*>(meta + 8 * slot_i);
      const int kk = meta[8 * slot_i + 4];
      if constexpr (XMODE) {
        const unsigned char* const sb = slot + a_raw;
        const int nq_n = (m.z >> 16) * 2;  // 4-column blocks
        int8_t* const bt = Bs + buf * ND_B * NC * lda;
        for (int blk = tid; blk < ND_XM * (kk / 4) * nq_n; blk += NTHR) {
          const int e = blk / ((kk / 4) * nq_n), r = blk - e * (kk / 4) * nq_n;
          const int kq = r / nq_n, nq = r - kq * nq_n;
          const unsigned char* src = sb + (e * kd + 4 * kq) * NC + 4 * nq;
          uint32_t x[4][ND_X];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t raw = *reinterpret_cast<const uint32_t*>(src + i * NC);
            if constexpr (XF == X_DIGITS) x[i][0] = raw;
            else xbytes(x[i], raw);
          }
          if constexpr (XF == X_DIGITS) {
            transpose4(bt + (e * NC + 4 * nq) * lda + 4 * kq, lda, x[0][0], x[1][0], x[2][0], x[3][0]);
          } else {
#pragma unroll
            for (int d = 0; d < ND_X; ++d)
              transpose4(bt + (d * NC + 4 * nq) * lda + 4 * kq, lda, x[0][d], x[1][d], x[2][d], x[3][d]);
          }
        }
      }
    };

    int acc[ND_B][8][4];
    zero(acc);
    uint32_t rs[2] = {0, 0};
    // the MMAs of one step, kk deep: A's fragments straight from the step's
    // packed words in slot `raw` (this warp's 16 rows of the tile are field
    // q of word rows wr_a, wr_a + 2 and their bytes kb: lane (g, t4) takes 4
    // columns' words and gathers byte kb of each, then bit q); B rows (n)
    // lda bytes apart, planes NC rows apart, from shared address b_u
    const int wr_a = ((16 * warp) & 31) / 4 + (g >> 2), kb = g & 3;
    const uint32_t sel = kb | ((kb + 4) << 4);
    const int bn = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
    auto frag = [&](const unsigned char* w, int q) {  // 4 columns' words -> 4 rows' bits
      const int4 v = *reinterpret_cast<const int4*>(w);
      const uint32_t lo = __byte_perm((uint32_t)v.x, (uint32_t)v.y, sel);
      const uint32_t hi = __byte_perm((uint32_t)v.z, (uint32_t)v.w, sel);
      return (__byte_perm(lo, hi, 0x5410) >> q) & 0x01010101u;
    };
    auto mma_step = [&](const unsigned char* raw, int q, uint32_t b_u, int ntc, int kk) {
      const uint32_t b_lane = b_u + bn * lda + bk;
      const unsigned char* const wa = raw + wr_a * a_ld + 16 * t4;
#pragma unroll 2
      for (int ks = 0; ks < kk; ks += 32) {
        uint32_t af[4];
        af[0] = frag(wa + 4 * ks, q);
        af[1] = frag(wa + 2 * a_ld + 4 * ks, q);
        af[2] = frag(wa + 4 * ks + 64, q);
        af[3] = frag(wa + 2 * a_ld + 4 * ks + 64, q);
        if constexpr (SG) {  // fragments 0, 2: row g; 1, 3: row g + 8
          rs[0] = dp4(af[2], dp4(af[0], rs[0]));
          rs[1] = dp4(af[3], dp4(af[1], rs[1]));
        }
#pragma unroll
        for (int e = 0; e < ND_B; ++e)
#pragma unroll
          for (int pr = 0; pr < 4; ++pr)
            if (2 * pr < ntc) {
              uint32_t bf[4];
              ldsm4_u(bf, b_lane + e * NC * lda + 16 * pr * lda + ks);
              const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
              mma_s8(acc[e][2 * pr], af, b0);
              mma_s8(acc[e][2 * pr + 1], af, b1);
            }
      }
    };
    // a unit ends: its rows requantized into Q or stored as logits; after a
    // tile's last pass, the tile's update. acc and rs are zeroed for the next.
    auto finish = [&](int m0, int n0, int ntc) {
      if constexpr (SG) reduce_rs(rs);
      if (l >= 0) agg_to_q<ND_B>(acc, rs, n0, ntc, shift);
      else store_out<ND_B, 8>(acc, rs, nullptr, m0, n0, ntc);
      if (l >= 0 && n0 + NC >= width) update_from_q(l, k, m0, dst, ushift);
      zero(acc);
      rs[0] = rs[1] = 0;
    };
    // units the schedule leaves empty, from `done` up to (not including) u
    auto finish_empty = [&](int& done, int u) {
      for (; done < u; ++done) {
        const int n0 = done % nch * NC;
        finish((rank + done / nch * p.cl) * RT, n0, min(NC, width - n0) / 8);
      }
    };

    // The ring: steps 0 .. S - 3 in flight; then per step j from -1: wait
    // for step j + 1, one barrier, issue step j + S - 1 (into the slot of
    // step j - 1, whose readers passed the barrier), unpack step j + 1,
    // MMAs of step j, and the unit's end after its last step.
    for (int i = 0; i < S - 2; ++i) {
      if (issued < total) issue();
      cp_commit();
    }
    int done = 0;    // units ended
    int cs = S - 1;  // step j's slot
    for (int j = -1; j < total; ++j) {
      const int ns = cs + 1 == S ? 0 : cs + 1;
      if (S == 4) cp_wait<1>();
      else cp_wait<0>();
      __syncthreads();
      if (issued < total) issue();
      cp_commit();
      if (XMODE && j + 1 < total) unpack(ns, (j + 1) & 1);
      if (j >= 0) {
        const int4 m = *reinterpret_cast<const int4*>(meta + 8 * cs);
        const int kk = meta[8 * cs + 4];
        if (m.w > done) finish_empty(done, m.w);
        const int n0 = m.z & 0xffff, ntc = m.z >> 16;
        // B in the step's slot, or X's transposed tile
        const uint32_t b_u = XMODE ? smem_u32(Bs + (j & 1) * ND_B * NC * lda) : ring_u + cs * p.slot + a_raw;
        mma_step(ring + cs * p.slot, ((m.y & 255) >> 5) + (warp >> 1), b_u, ntc, kk);
        if (j + 1 == total || meta[8 * ns + 3] != m.w) {
          finish(m.y, n0, ntc);
          ++done;
        }
      }
      cs = ns;
    }
    finish_empty(done, nunits);
    cp_wait<0>();
  }

  // This warp's rows of a pass, requantized into Q at columns n0..
  // (ND_H digit planes, or the signed plane of level - 128).
  template <int ND_B>
  __device__ void agg_to_q(const int (&acc)[ND_B][8][4], const uint32_t (&rs)[2], int n0, int ntc,
                           int shift) const {
    int8_t* const q = reinterpret_cast<int8_t*>(sm + p.off_q);
    const size_t qplane = (size_t)RT * p.qld;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (nt < ntc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h, col = n0 + nt * 8 + 2 * t4;
          int r[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t s = 0;  // unsigned: the shifted sum wraps like int32
#pragma unroll
            for (int e = 0; e < ND_B; ++e) s += (uint32_t)acc[e][nt][2 * h + j] << (4 * e);
            if constexpr (SG) s += rs[h] << 7;
            r[j] = requant((int)s, p.out_bits, shift);
          }
          put_levels<ND_H>(q + (size_t)row * p.qld + col, qplane, r[0], r[1]);
        }
  }

  // Two requantized levels as ND digit planes `plane` bytes apart (SG: the
  // offset-signed byte).
  template <int ND>
  __device__ __forceinline__ void put_levels(int8_t* dst, size_t plane, int r0, int r1) const {
    if constexpr (SG) {
      char2 c;
      c.x = (char)(r0 - 128);
      c.y = (char)(r1 - 128);
      *reinterpret_cast<char2*>(dst) = c;
    } else {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int mask = (1 << min(4, p.out_bits - 4 * d)) - 1;
        char2 c;
        c.x = (char)((r0 >> (4 * d)) & mask);
        c.y = (char)((r1 >> (4 * d)) & mask);
        *reinterpret_cast<char2*>(dst + d * plane) = c;
      }
    }
  }

  // float32 logits of this warp's rows: columns below oc.
  template <int NS, int NT>
  __device__ void store_out(const int (&acc)[NS][NT][4], const uint32_t (&rs)[2], const int* corr,
                            int m0, int n0, int ntc) const {
    float* const out = p.out + (size_t)b * p.pn * p.oc;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < ntc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 16 * warp + g + 8 * h, col = n0 + nt * 8 + 2 * t4;
          if (col >= p.oc) continue;
          uint32_t v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t s = 0;
#pragma unroll
            for (int si = 0; si < NS; ++si) s += (uint32_t)acc[si][nt][2 * h + j] << (4 * si);
            if constexpr (SG) {
              s += rs[h] << 7;
              if (corr) s += (uint32_t)__ldg(corr + col + j);
            }
            v[j] = s;
          }
          *reinterpret_cast<float2*>(out + (size_t)row * p.oc + col) =
              make_float2((float)(int)v[0], (float)(int)v[1]);
        }
  }

  // -- the update: warp-local ----------------------------------------------

  // acc[d + e] += A_d[16 rows of this warp, k0 .. k0 + kk) x W_e^T, W^T
  // staged with rows `wl` bytes apart, columns n0 .. n0 + 8 ntc; A rows
  // `ald` bytes apart, ND_A planes `aplane` apart, column ka0 at k0.
  template <int ND_A, int NT>
  __device__ void update_mma(int (&acc)[ND_A + ND_W - 1][NT][4], uint32_t (&rs)[2],
                             const int8_t* a_sm, int ald, int aplane, int ka0, int k0, int kk,
                             int nw, int wl, int n0, int ntc) const {
    const int8_t* const wt = reinterpret_cast<const int8_t*>(sm + p.off_wt);
    const int ar = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 16;
    const int bn = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
    for (int ks = 0; ks < kk; ks += 32) {
      uint32_t af[ND_A][4];
#pragma unroll
      for (int d = 0; d < ND_A; ++d) ldsm4(af[d], a_sm + (size_t)d * aplane + (size_t)ar * ald + ka0 + ks + ak);
      if constexpr (SG) {
        rs[0] = dp4(af[0][2], dp4(af[0][0], rs[0]));
        rs[1] = dp4(af[0][3], dp4(af[0][1], rs[1]));
      }
#pragma unroll
      for (int e = 0; e < ND_W; ++e)
#pragma unroll
        for (int pr = 0; 2 * pr < NT; ++pr)
          if (2 * pr < ntc) {
            uint32_t bf[4];
            ldsm4(bf, wt + ((size_t)e * nw + n0 + 16 * pr + bn) * wl + k0 + ks + bk);
            const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
            for (int d = 0; d < ND_A; ++d) {
              mma_s8(acc[d + e][2 * pr], af[d], b0);
              mma_s8(acc[d + e][2 * pr + 1], af[d], b1);
            }
          }
    }
  }

  // This warp's rows of an update's pass, requantized into the hidden
  // plane P^T (dst: [ND_H][hw][pn] of this batch) through the warp's
  // staging tile, 16 rows of a column in one 16-byte store.
  template <int NS, int NT>
  __device__ void update_to_p(const int (&acc)[NS][NT][4], const uint32_t (&rs)[2], const int* corr,
                              int8_t* dst, int m0, int n0, int ntc, int shift) const {
    int8_t* const st = reinterpret_cast<int8_t*>(sm + p.off_pst) + warp * ND_H * NC * 16;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < ntc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = g + 8 * h, col = nt * 8 + 2 * t4;
          int r[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t s = 0;
#pragma unroll
            for (int si = 0; si < NS; ++si) s += (uint32_t)acc[si][nt][2 * h + j] << (4 * si);
            if constexpr (SG) {
              s += rs[h] << 7;
              if (corr) s += (uint32_t)__ldg(corr + n0 + col + j);
            }
            r[j] = requant((int)s, p.out_bits, shift);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if constexpr (SG) {
              st[(col + j) * 16 + row] = (int8_t)(r[j] - 128);
            } else {
#pragma unroll
              for (int d = 0; d < ND_H; ++d)
                st[(d * NC + col + j) * 16 + row] =
                    (int8_t)((r[j] >> (4 * d)) & ((1 << min(4, p.out_bits - 4 * d)) - 1));
            }
          }
        }
    __syncwarp();
    const int cols = ntc * 8;
    for (int c = lane; c < ND_H * cols; c += 32) {
      const int d = c / cols, col = c - d * cols;
      *reinterpret_cast<int4*>(dst + d * hplane + (size_t)(n0 + col) * p.pn + m0 + 16 * warp) =
          *reinterpret_cast<const int4*>(st + (d * NC + col) * 16);
    }
    __syncwarp();
  }

  // Layer l's update of this warp's rows of tile m0: Q (the aggregation's
  // rows) x W_l over K = round_up(k, 32) -> P^T `dst` or, when dst is null,
  // the logits.
  __device__ __noinline__ void update_from_q(int l, int k, int m0, int8_t* dst, int shift) const {
    constexpr int NS = ND_H + ND_W - 1, UNC = NS == 1 ? NC : NC / 2;  // columns a pass
    const int8_t* const q = reinterpret_cast<const int8_t*>(sm + p.off_q);
    const int nw = p.nw[l], wl = wld(k), K = round_up(k, 32);
    const int* const corr = SG ? p.corr + p.c_off[l] : nullptr;
    __syncwarp();  // this warp's Q rows are written
    for (int n0 = 0; n0 < nw; n0 += UNC) {
      const int ntc = min(UNC, nw - n0) / 8;
      int acc[NS][UNC / 8][4];
      zero(acc);
      uint32_t rs[2] = {0, 0};
      update_mma<ND_H, UNC / 8>(acc, rs, q, p.qld, RT * p.qld, 0, 0, K, nw, wl, n0, ntc);
      if constexpr (SG) reduce_rs(rs);
      if (dst) update_to_p<NS, UNC / 8>(acc, rs, corr, dst, m0, n0, ntc, shift);
      else store_out<NS, UNC / 8>(acc, rs, corr, m0, n0, ntc);
    }
    __syncwarp();  // Q's rows are read before the next tile writes them
  }

  // GCN's first update, X W_0, for this warp's rows of tile m0: X's rows
  // read into the warp's rows of XT (converted to ND_X planes) in chunks of
  // at most XCHUNK columns; into P^T `dst`.
  __device__ __noinline__ void update_from_x(int m0, int8_t* dst) const {
    constexpr int NS = ND_X + ND_W - 1, UNC = NS == 1 ? NC : NC / 2;  // columns a pass
    const int xld = min(p.xp, XCHUNK) + 16, nw = p.nw[0], wl = wld(p.xp);
    int8_t* const xt = reinterpret_cast<int8_t*>(sm);
    const size_t xtp = (size_t)RT * xld;
    const int8_t* const xb = p.x + (size_t)b * ND_XM * p.pn * p.xp;
    const int* const corr = SG ? p.corr + p.c_off[0] : nullptr;
    const bool one = p.xp <= XCHUNK;  // X's rows read once for every pass
    for (int n0 = 0; n0 < nw; n0 += UNC) {
      const int ntc = min(UNC, nw - n0) / 8;
      int acc[NS][UNC / 8][4];
      zero(acc);
      uint32_t rs[2] = {0, 0};
      for (int k0 = 0; k0 < p.xp; k0 += XCHUNK) {
        const int kk = min(XCHUNK, p.xp - k0);
        if (!one || n0 == 0) {
          __syncwarp();  // the previous chunk's fragments are read
          const int per = kk / 16;  // 16-byte chunks of a row
          for (int c = lane; c < ND_XM * 16 * per; c += 32) {
            const int e = c / (16 * per), r = c - e * 16 * per;
            const int row = r / per, cc = (r - row * per) * 16;
            const int4 raw = __ldg(reinterpret_cast<const int4*>(
                xb + (size_t)e * p.pn * p.xp + (size_t)(m0 + 16 * warp + row) * p.xp + k0 + cc));
            const uint32_t w4[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
            uint32_t v[4][ND_X];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if constexpr (XF == X_DIGITS) v[i][0] = w4[i];
              else xbytes(v[i], w4[i]);
            }
            int8_t* const dst_row = xt + (size_t)(16 * warp + row) * xld + cc;
            if constexpr (XF == X_DIGITS) {
              *reinterpret_cast<int4*>(dst_row + e * xtp) = raw;
            } else {
#pragma unroll
              for (int d = 0; d < ND_X; ++d)
                *reinterpret_cast<int4*>(dst_row + d * xtp) =
                    make_int4((int)v[0][d], (int)v[1][d], (int)v[2][d], (int)v[3][d]);
            }
          }
          __syncwarp();
        }
        update_mma<ND_X, UNC / 8>(acc, rs, xt, xld, (int)xtp, 0, k0, kk, nw, wl, n0, ntc);
      }
      if constexpr (SG) reduce_rs(rs);
      update_to_p<NS, UNC / 8>(acc, rs, corr, dst, m0, n0, ntc, p.shift[0]);
    }
    __syncwarp();
  }

  template <int NS, int NT>
  static __device__ __forceinline__ void zero(int (&acc)[NS][NT][4]) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][nt][i] = 0;
  }

  // the 4 lanes of a row group hold its 4 column slices
  static __device__ __forceinline__ void reduce_rs(uint32_t (&rs)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
  }

  __device__ void run() const {
    const int n = p.n_layers;
    if (!p.gin) {
      // upd 0: X W_0, row-local
      stage_weights(0, p.xp);
      __syncthreads();
      for (int t = rank; t < ntiles(); t += p.cl) update_from_x(t * RT, P(0));
      cluster_sync();
      for (int l = 1; l < n; ++l) {
        stage_weights(l, p.nw[l - 1]);  // published by the first pass's barriers
        aggregate<ND_H, false>(P((l - 1) & 1), p.nw[l - 1], p.shift[2 * l - 1], l, p.nw[l - 1],
                               P(l & 1), p.shift[2 * l]);
        cluster_sync();
      }
      aggregate<ND_H, false>(P((n - 1) & 1), p.nw[n - 1], 0, -1, 0, nullptr, 0);
    } else {
      const int8_t* const xb = p.x + (size_t)b * ND_XM * p.pn * p.xp;
      for (int l = 0; l < n; ++l) {
        stage_weights(l, l ? p.nw[l - 1] : p.xp);
        int8_t* const dst = l < n - 1 ? P(l & 1) : nullptr;
        const int ushift = l < n - 1 ? p.shift[2 * l + 1] : 0;
        if (l == 0)
          aggregate<ND_X, true>(xb, p.xp, p.shift[0], 0, p.xp, dst, ushift);
        else
          aggregate<ND_H, false>(P((l - 1) & 1), p.nw[l - 1], p.shift[2 * l], l, p.nw[l - 1], dst,
                                 ushift);
        if (l < n - 1) cluster_sync();
      }
    }
  }
};

template <int XF, int ND_X, int ND_W, int ND_H, int RT>
__global__ void __launch_bounds__(RT * 2, 1)
    k1_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Chain<XF, ND_X, ND_W, ND_H, RT> c(p, smem);
  c.run();
}

// One launch: B clusters of cl CTAs, `smem` bytes of dynamic shared
// memory (set as the kernel's limit first: above 48 KB it must be). A
// refused launch is returned, not raised.
template <int XF, int ND_X, int ND_W, int ND_H, int RT>
int launch_rt(const Params& p, int smem, cudaStream_t s) {
  auto kern = k1_kernel<XF, ND_X, ND_W, ND_H, RT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.cl);
  cfg.blockDim = dim3(RT * 2);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Every launch of one form of X (XF, ND_X) at one tile height RT, over
// the weights' and the hidden plane's digit planes; a translation unit
// each (fused_model_f*.cu), so that nvcc builds them in parallel.
template <int XF, int ND_X, int RT>
int launch_form(const Params& p, int nd_w, int nd_h, int smem, cudaStream_t s) {
  if constexpr (XF == X_SIGNED) {
    return nd_w == 1 && nd_h == 1 ? launch_rt<XF, ND_X, 1, 1, RT>(p, smem, s) : (int)cudaErrorInvalidValue;
  } else {
    if (nd_w == 1 && nd_h == 1) return launch_rt<XF, ND_X, 1, 1, RT>(p, smem, s);
    if (nd_w == 1 && nd_h == 2) return launch_rt<XF, ND_X, 1, 2, RT>(p, smem, s);
    if (nd_w == 2 && nd_h == 1) return launch_rt<XF, ND_X, 2, 1, RT>(p, smem, s);
    if (nd_w == 2 && nd_h == 2) return launch_rt<XF, ND_X, 2, 2, RT>(p, smem, s);
    return (int)cudaErrorInvalidValue;
  }
}

#define QGTC_K1_FORMS(X)                                                 \
  X(X_DIGITS, 1, 64) X(X_DIGITS, 1, 128) X(X_DIGITS, 2, 64) X(X_DIGITS, 2, 128) \
  X(X_SPLIT, 1, 64) X(X_SPLIT, 1, 128) X(X_SPLIT, 2, 64) X(X_SPLIT, 2, 128)     \
  X(X_SIGNED, 1, 64) X(X_SIGNED, 1, 128)
#define QGTC_K1_EXTERN(XF, NDX, RT) \
  extern template int launch_form<XF, NDX, RT>(const Params&, int, int, int, cudaStream_t);
QGTC_K1_FORMS(QGTC_K1_EXTERN)
#undef QGTC_K1_EXTERN

}  // namespace k1
}  // namespace qgtc
