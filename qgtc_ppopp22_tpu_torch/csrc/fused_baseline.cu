// fused_baseline: a bucket's whole full-precision (bf16) model in one launch.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/fused_model.py::
// fused_baseline_epoch (:1299, pallas_call at :1427), the baseline the
// quantized engine is compared with. Per batch and layer:
//   h = relu(bf16(bf16(A @ h) @ W))    (no relu after the last layer,
//                                        which stores float32 logits)
// with both products summed in float32 and the JAX kernel's rounding
// points (fused_model.py:1404-1414): X rounds to bf16 once, each
// aggregation's f32 sum rounds to bf16 before the update, each relu
// output rounds to bf16. Every rounding is __float2bfloat16_rn (to
// nearest even, as JAX's astype); A (int8 0/1) converts to bf16 exactly.
//
// What bounds it on an H100: reading A. At C1 (75 batches, pn = 2560)
// the int8 adjacency is 491.5 MB per epoch; the bf16 MMAs are 157 GFLOP
// (0.16 ms at 989 TFLOP/s) and reading A, X and the logits once is 620 MB
// (0.19 ms at 3.35 TB/s). A batch's A (6.5 MB) would fit the 50 MB L2,
// but the dozens of batches in flight at once do not, so this kernel
// reads A once per layer from device memory (3 x 491.5 MB at C1); the
// previous layer's bf16 rows come from L2.
//
// Design (the first K1's scaffolding): one launch per bucket, one
// thread-block cluster of CL <= 8 CTAs per batch, CTA r owning the 64-row
// tiles r, r + CL, ... First each CTA rounds its rows of X into the bf16
// ping-pong scratch P0; a cluster barrier (after __threadfence) separates
// the phases. Per layer and tile, 4 warps of 16 rows run
// mma.sync.m16n8k16 bf16 over the whole contraction in 64-deep stages:
// the int8 A tile and the bf16 h tile arrive by cp.async.cg (L2 only:
// the scratch is written during the launch) into a two-stage ring; A
// converts to bf16 as its fragments are read, h's fragments come from
// ldmatrix.trans. The aggregation's f32 accumulators of up to 128
// columns round to bf16 and are, in registers, the A fragments of the
// update against W (staged transposed in shared memory once per layer),
// so the aggregated tile never leaves the SM. The update's rows go to the
// other scratch buffer, which the next layer reads whole after the
// cluster barrier. Widths are padded to 16 by the wrapper with zero
// weights; relu(0) = 0 keeps the padding zero, and only cp logit columns
// are stored.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LAYERS = 8;   // ops/fused_model.py BASELINE_MAX_LAYERS
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int THREADS = 128;    // 4 warps, 16 rows each
constexpr int BM = 64;          // rows per tile
constexpr int BK = 64;          // aggregation depth per stage
constexpr int NC = 128;         // aggregation columns per pass (16 n-tiles)
constexpr int LDA = BK + 16;    // int8 A row stride in bytes (20 words:
                                // a fragment's 8 rows in distinct banks)
constexpr int LDH = NC + 8;     // bf16 h row stride (272 bytes: ldmatrix's
                                // 8 rows in distinct banks)
constexpr int SMEM_A = 2 * BM * LDA;                // bytes
constexpr int SMEM_H = 2 * BK * LDH * 2;            // bytes

using bf16 = __nv_bfloat16;

struct Params {
  float* out;          // [B][pn][cp]
  const int8_t* a;     // [B][pn][pn]
  const float* x;      // [B][pn][xp]
  const bf16* w;       // layer l at element w_off[l]: W_l^T [np[l]][kp[l]]
  bf16* scratch;       // [B][2][pn][hw]: P0, P1
  int B, pn, xp, cp, hw, n_layers, cl;
  int kp[MAX_LAYERS], np[MAX_LAYERS], w_off[MAX_LAYERS];
};

__device__ __forceinline__ void cluster_sync() {
  __threadfence();  // scratch writes reach L2 before the barrier
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fragments of a k16 x n16 block of a row-major [k][n] bf16 tile:
// r[0], r[1] for columns 0-7, r[2], r[3] for columns 8-15.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> bf16x2, each rounded to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h =
      __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two int8 (the low byte first) -> bf16x2, exact.
__device__ __forceinline__ uint32_t i8x2(const int8_t* p) {
  return bf16x2((float)p[0], (float)p[1]);
}

// One 64-row tile of one layer: agg = A[m0:m0+64, :] @ hin[:, :kin] in
// f32, rounded to bf16, then agg @ W (Ws: W^T [np][kp + 8] in shared
// memory) in f32; relu and bf16 into hout, or f32 logits into out.
template <int NTU>
__device__ __forceinline__ void tile_layer(const Params& p, int8_t* As, bf16* Hs,
                                           const bf16* Ws, const int8_t* ab,
                                           const bf16* hin, int kin, int np,
                                           bool last, int m0, bf16* hout,
                                           float* outb) {
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int ldw = kin + 8, ntu = np / 8, nk = p.pn / BK;
  float accu[NTU][4];
#pragma unroll
  for (int u = 0; u < NTU; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) accu[u][i] = 0.f;

  for (int c0 = 0; c0 < kin; c0 += NC) {
    const int nt = min(NC, kin - c0) / 8;  // n-tiles, = 16-byte chunks of an h row
    float acc[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    auto load_stage = [&](int s, int k0) {
      int8_t* as = As + s * BM * LDA;
      bf16* hs = Hs + s * BK * LDH;
      for (int i = tid; i < BM * (BK / 16); i += THREADS) {
        const int r = i / (BK / 16), kc = (i % (BK / 16)) * 16;
        cp_async16(as + r * LDA + kc, ab + (size_t)(m0 + r) * p.pn + k0 + kc);
      }
      for (int i = tid; i < BK * nt; i += THREADS) {
        const int r = i / nt, cc = (i % nt) * 8;
        cp_async16(hs + r * LDH + cc, hin + (size_t)(k0 + r) * p.hw + c0 + cc);
      }
      cp_async_commit();
    };

    load_stage(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt & 1;
      if (kt + 1 < nk) {
        load_stage(s ^ 1, (kt + 1) * BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* as = As + s * BM * LDA;
      const bf16* hs = Hs + s * BK * LDH;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        const int8_t* pa = as + (wm + g) * LDA + ks + t4 * 2;
        const uint32_t af[4] = {i8x2(pa), i8x2(pa + 8 * LDA), i8x2(pa + 8),
                                i8x2(pa + 8 * LDA + 8)};
#pragma unroll
        for (int j = 0; j < NC / 16; ++j) {
          if (2 * j < nt) {
            uint32_t b[4];
            ldsm_x4_trans(b, hs + (ks + (lane & 15)) * LDH + j * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * j], af, b[0], b[1]);
            mma_bf16(acc[2 * j + 1], af, b[2], b[3]);
          }
        }
      }
      __syncthreads();  // stage s is free for the load of stage kt + 2
    }

    // The update over this chunk's columns: the accumulators of n-tiles
    // 2j and 2j + 1, rounded to bf16, are the A fragment of k-block j.
#pragma unroll
    for (int j = 0; j < NC / 16; ++j) {
      if (2 * j < nt) {
        const uint32_t af[4] = {bf16x2(acc[2 * j][0], acc[2 * j][1]),
                                bf16x2(acc[2 * j][2], acc[2 * j][3]),
                                bf16x2(acc[2 * j + 1][0], acc[2 * j + 1][1]),
                                bf16x2(acc[2 * j + 1][2], acc[2 * j + 1][3])};
        const int k = c0 + 16 * j + t4 * 2;
#pragma unroll
        for (int u = 0; u < NTU; ++u) {
          if (u < ntu) {
            const bf16* pw = Ws + (u * 8 + g) * ldw + k;
            mma_bf16(accu[u], af, *reinterpret_cast<const uint32_t*>(pw),
                     *reinterpret_cast<const uint32_t*>(pw + 8));
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < NTU; ++u) {
    if (u >= ntu) continue;
    const int col = u * 8 + t4 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const int row = m0 + wm + g + 8 * h;
      const float v0 = accu[u][2 * h], v1 = accu[u][2 * h + 1];
      if (last) {
        float* o = outb + (size_t)row * p.cp + col;
        if (col < p.cp) o[0] = v0;
        if (col + 1 < p.cp) o[1] = v1;
      } else {
        *reinterpret_cast<uint32_t*>(hout + (size_t)row * p.hw + col) =
            bf16x2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

template <int NTU>
__global__ void __launch_bounds__(THREADS) fused_baseline_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const As = reinterpret_cast<int8_t*>(smem);
  bf16* const Hs = reinterpret_cast<bf16*>(smem + SMEM_A);
  bf16* const Ws = reinterpret_cast<bf16*>(smem + SMEM_A + SMEM_H);

  const int b = blockIdx.x / p.cl, rank = blockIdx.x % p.cl, tid = threadIdx.x;
  const size_t plane = (size_t)p.pn * p.hw;
  bf16* const P[2] = {p.scratch + (size_t)b * 2 * plane,
                      p.scratch + (size_t)b * 2 * plane + plane};
  const int8_t* const ab = p.a + (size_t)b * p.pn * p.pn;
  const float* const xb = p.x + (size_t)b * p.pn * p.xp;
  float* const outb = p.out + (size_t)b * p.pn * p.cp;
  const int n = p.n_layers, kx = p.kp[0];

  // X -> bf16 (zero past xp) in P0, this CTA's rows only
  for (int t = rank; t < p.pn / BM; t += p.cl)
    for (int i = tid; i < BM * kx; i += THREADS) {
      const int row = t * BM + i / kx, col = i % kx;
      const float v = col < p.xp ? __ldg(xb + (size_t)row * p.xp + col) : 0.f;
      P[0][(size_t)row * p.hw + col] = __float2bfloat16_rn(v);
    }
  cluster_sync();

  for (int l = 0; l < n; ++l) {
    const int kin = p.kp[l], np = p.np[l], ldw = kin + 8;
    __syncthreads();  // the previous layer's readers of Ws are done
    const bf16* wl = p.w + p.w_off[l];
    for (int i = tid; i < np * (kin / 8); i += THREADS) {
      const int r = i / (kin / 8), c = (i % (kin / 8)) * 8;
      *reinterpret_cast<int4*>(Ws + r * ldw + c) =
          __ldg(reinterpret_cast<const int4*>(wl + (size_t)r * kin + c));
    }
    __syncthreads();
    for (int t = rank; t < p.pn / BM; t += p.cl)
      tile_layer<NTU>(p, As, Hs, Ws, ab, P[l & 1], kin, np, l == n - 1, t * BM,
                      P[(l + 1) & 1], outb);
    if (l < n - 1) cluster_sync();
  }
}

template <int NTU>
int launch(const Params& p, int smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(fused_baseline_kernel<NTU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_baseline_kernel<NTU>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// meta (host ints): B, pn, xp, cp, hw, n_layers; then per layer kp, np,
// w_off (elements). Shapes as in Params; ops/fused_model.py checks them
// first and this entry refuses anything the kernel cannot index safely.
extern "C" int qgtc_fused_baseline(void* out, const void* a, const void* x,
                                   const void* w, void* scratch, const int* meta,
                                   int n_meta, void* stream) {
  if (n_meta < 6) return (int)cudaErrorInvalidValue;
  Params p{};
  p.out = static_cast<float*>(out);
  p.a = static_cast<const int8_t*>(a);
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const bf16*>(w);
  p.scratch = static_cast<bf16*>(scratch);
  p.B = meta[0];
  p.pn = meta[1];
  p.xp = meta[2];
  p.cp = meta[3];
  p.hw = meta[4];
  p.n_layers = meta[5];
  const int n = p.n_layers;
  if (n < 1 || n > MAX_LAYERS || n_meta != 6 + 3 * n) return (int)cudaErrorInvalidValue;
  bool ok = p.B > 0 && p.pn > 0 && p.pn % 256 == 0 && p.xp > 0 && p.cp > 0 &&
            p.hw > 0 && p.hw % 8 == 0;
  int wmax = 0;
  for (int l = 0; l < n && ok; ++l) {
    p.kp[l] = meta[6 + 3 * l];
    p.np[l] = meta[7 + 3 * l];
    p.w_off[l] = meta[8 + 3 * l];
    ok = p.kp[l] > 0 && p.kp[l] % 16 == 0 && p.np[l] > 0 && p.np[l] % 16 == 0 &&
         p.np[l] <= 128 && p.w_off[l] % 8 == 0 && p.kp[l] <= p.hw &&
         (l == 0 ? p.kp[0] >= p.xp : p.kp[l] == p.np[l - 1]);
    wmax = std::max(wmax, p.np[l] * (p.kp[l] + 8) * 2);  // W^T in shared memory
  }
  ok = ok && p.cp <= p.np[n - 1];
  const int smem = SMEM_A + SMEM_H + wmax;
  if (!ok || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  p.cl = p.pn / BM < MAX_CLUSTER ? p.pn / BM : MAX_CLUSTER;
  int npmax = 0;
  for (int l = 0; l < n; ++l) npmax = std::max(npmax, p.np[l]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return npmax <= 64 ? launch<8>(p, smem, s) : launch<16>(p, smem, s);
}
