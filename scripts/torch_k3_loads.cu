// How fast one SM moves a K3 window between L2 and shared memory, by the
// shape of its accesses: the measurement behind the resident instance's
// load and update passes in dlaf_tpu_torch/csrc/band2tridiag.cu.
//
// Strip storage at n = 8192, b = 128, f32 (row pitch 5b floats, strip s
// shifted by s*b, as band_strips.py lays it out); block k handles the
// window of chase (s = it, c = 3k), it = 0, 1, ..., as lane k of K3 does,
// 22 blocks (K3's lanes at n = 8192) or one. Each case, a microsecond
// figure per window over many windows:
//   rows_4b      the window's 2b rows ([CY | S's lower triangle], B) in
//                4-byte loads, 4 rows x 8 loads a lane in flight
//   rows_16b     the same rows as the 16-byte chunks that cover them, 4
//                rows x 3 chunks a lane in flight
//   segments_16b the same window cut into CY, S and B row segments, 16-byte
//                chunks, 8 segments x 2 chunks a lane in flight
//   store_4b     the rows written back, 4-byte stores, then a fence
//   store_16b    the same in 16-byte stores (the rows' 16-byte-aligned
//                cover; timing only)
//   rows_cp_async_16b  the rows' 16-byte chunks as cp.async.cg copies
//                straight into shared memory, every chunk of the window in
//                flight at once (no register staging), then one wait
//   rows_bulk    each row's 16-byte cover as one cp.async.bulk (TMA) copy,
//                a row a thread, all 2b rows in flight, completing on one
//                mbarrier (K3's resident loads)
//   store_bulk   the rows' 16-byte covers written back as cp.async.bulk
//                copies from shared memory, then a wait and a fence
//                (timing only)
// Build and run (scripts/torch_chip_probes.py k3_loads does both):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o k3_loads scripts/torch_k3_loads.cu
//   ./k3_loads
#include <cstdio>
#include <cstring>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512, kWarps = 16, kB = 128, kN = 8192;
constexpr int kLS = 264, kLB = 136;   // shared-memory row strides in floats, as K3's

__device__ __forceinline__ float* row_of(float* strips, long long i0, int g) {
  const long long s0 = i0 / kB;
  const int im = (int)(i0 - s0 * kB);
  const long long strip = s0 + (g + im >= 2 * kB ? 2 : (g + im >= kB ? 1 : 0));
  return strips + (i0 + g) * 5LL * kB - strip * kB + 3LL * kB + (i0 - kB);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(kThreads, 1) window(float* strips, int mode, int reps, float* sink) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) unsigned long long bar;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* bs = sm + kB * kLS;
  float acc = 0.f;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  for (int it = 0; it < reps; ++it) {
    const long long i0 = (it % 4000) + 1 + 3LL * kB * blockIdx.x;
    const int sh = (int)((reinterpret_cast<uintptr_t>(row_of(strips, i0, 0)) >> 2) & 3);
    if (mode == 0) {
      for (int g0 = warp; g0 < 2 * kB; g0 += kWarps * 4) {
        float x[4][8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = g0 + k * kWarps, len = g < kB ? kB + g + 1 : kB;
          const float* seg = g < kB ? row_of(strips, i0, g) : row_of(strips, i0, g) + kB;
#pragma unroll
          for (int j = 0; j < 8; ++j) x[k][j] = 32 * j + lane < len ? __ldcg(seg + 32 * j + lane) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = g0 + k * kWarps, len = g < kB ? kB + g + 1 : kB;
          float* dst = g < kB ? sm + g * kLS : bs + (g - kB) * kLB;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (32 * j + lane < len) dst[sh + 32 * j + lane] = x[k][j];
        }
      }
    } else if (mode == 1) {
      for (int g0 = warp; g0 < 2 * kB; g0 += kWarps * 4) {
        float4 x[4][3];
        int nch[4];
        float* dst[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = g0 + k * kWarps;
          const float* seg = g < kB ? row_of(strips, i0, g) : row_of(strips, i0, g) + kB;
          nch[k] = (sh + (g < kB ? kB + g + 1 : kB) + 3) / 4;
          dst[k] = g < kB ? sm + g * kLS : bs + (g - kB) * kLB;
          const float4* span = reinterpret_cast<const float4*>(seg - sh);
#pragma unroll
          for (int j = 0; j < 3; ++j)
            x[k][j] = 32 * j + lane < nch[k] ? __ldcg(span + 32 * j + lane) : make_float4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (32 * j + lane < nch[k]) reinterpret_cast<float4*>(dst[k])[32 * j + lane] = x[k][j];
      }
    } else if (mode == 2) {
      for (int r0 = warp; r0 < 3 * kB; r0 += kWarps * 8) {
        float4 x[8][2];
        int nch[8];
        float* dst[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int sr = r0 + k * kWarps, region = sr < kB ? 0 : (sr < 2 * kB ? 1 : 2);
          const int r = sr - region * kB;
          const float* seg = region == 2 ? row_of(strips, i0, kB + r) + kB
                                         : row_of(strips, i0, r) + (region == 1 ? kB : 0);
          nch[k] = sr < 3 * kB ? (sh + (region == 1 ? r + 1 : kB) + 3) / 4 : 0;
          dst[k] = region == 0 ? sm + r * kLS : region == 1 ? sm + r * kLS + kB : bs + r * kLB;
          const float4* span = reinterpret_cast<const float4*>(seg - sh);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            x[k][j] = 32 * j + lane < nch[k] ? __ldcg(span + 32 * j + lane) : make_float4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (32 * j + lane < nch[k]) reinterpret_cast<float4*>(dst[k])[32 * j + lane] = x[k][j];
      }
    } else if (mode == 5) {
      for (int g = warp; g < 2 * kB; g += kWarps) {
        const float* seg = g < kB ? row_of(strips, i0, g) : row_of(strips, i0, g) + kB;
        const int nch = (sh + (g < kB ? kB + g + 1 : kB) + 3) / 4;
        float* dst = g < kB ? sm + g * kLS : bs + (g - kB) * kLB;
        const float4* span = reinterpret_cast<const float4*>(seg - sh);
        for (int ch = lane; ch < nch; ch += 32)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + 4 * ch)),
                       "l"(span + ch) : "memory");
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    } else if (mode == 6) {
      if (tid < 2 * kB) {
        const int g = tid;
        const float* seg = g < kB ? row_of(strips, i0, g) : row_of(strips, i0, g) + kB;
        const unsigned bytes = 16u * ((sh + (g < kB ? kB + g + 1 : kB) + 3) / 4);
        float* dst = g < kB ? sm + g * kLS : bs + (g - kB) * kLB;
        asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
                     ::"r"(smem_addr(&bar)), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                     ::"r"(smem_addr(dst)), "l"(seg - sh), "r"(bytes), "r"(smem_addr(&bar)) : "memory");
      }
      __syncthreads();
      if (tid == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(&bar)) : "memory");
      unsigned ok = 0;
      while (!ok)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                     : "=r"(ok) : "r"(smem_addr(&bar)), "r"((unsigned)(it & 1)) : "memory");
    } else if (mode == 7) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (tid < 2 * kB) {
        const int g = tid;
        float* seg = g < kB ? row_of(strips, i0, g) : row_of(strips, i0, g) + kB;
        const unsigned bytes = 16u * ((sh + (g < kB ? kB + g + 1 : kB) + 3) / 4);
        const float* src = g < kB ? sm + g * kLS : bs + (g - kB) * kLB;
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                     ::"l"(seg - sh), "r"(smem_addr(src)), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group 0;" ::: "memory");
      }
      __threadfence();
    } else if (mode == 3) {
      for (int g = warp; g < 2 * kB; g += kWarps) {
        const int len = g < kB ? kB + g + 1 : kB;
        float* dst = g < kB ? row_of(strips, i0, g) : row_of(strips, i0, g) + kB;
        const float* src = g < kB ? sm + g * kLS : bs + (g - kB) * kLB;
        for (int c = lane; c < len; c += 32) dst[c] = src[sh + c];
      }
      __threadfence();
    } else {
      for (int g = warp; g < 2 * kB; g += kWarps) {
        const int nch = (sh + (g < kB ? kB + g + 1 : kB) + 3) / 4;
        float* seg = g < kB ? row_of(strips, i0, g) : row_of(strips, i0, g) + kB;
        float4* dst = reinterpret_cast<float4*>(seg - sh);
        const float4* src = reinterpret_cast<const float4*>(g < kB ? sm + g * kLS : bs + (g - kB) * kLB);
        for (int ch = lane; ch < nch; ch += 32) dst[ch] = src[ch];
      }
      __threadfence();
    }
    __syncthreads();
    acc += sm[(it * 37 + tid) % (kB * kLS)];
    __syncthreads();
  }
  if (acc == 12345.f) sink[0] = acc;
}

}  // namespace

int main() {
  const char* names[] = {"rows_4b",   "rows_16b",          "segments_16b", "store_4b",
                         "store_16b", "rows_cp_async_16b", "rows_bulk",    "store_bulk"};
  const int reps = 2000, lanes = 22;
  const size_t nfloats = (size_t)(kN / kB + 3 + 3 * lanes + 32) * kB * 5 * kB;
  float *strips, *sink;
  if (cudaMalloc(&strips, nfloats * 4) != cudaSuccess || cudaMalloc(&sink, 4) != cudaSuccess) return 1;
  cudaMemset(strips, 0, nfloats * 4);
  const int smem = (kB * (kLS + kLB)) * 4;
  cudaFuncSetAttribute(window, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int mode = 0; mode < 8; ++mode)
    for (int blocks : {1, lanes}) {
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      window<<<blocks, kThreads, smem>>>(strips, mode, 10, sink);
      cudaEventRecord(a);
      window<<<blocks, kThreads, smem>>>(strips, mode, reps, sink);
      cudaEventRecord(b);
      const cudaError_t e = cudaEventSynchronize(b);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, a, b);
      if (e != cudaSuccess) {
        printf("error %s\n", cudaGetErrorString(e));
        return 1;
      }
      printf("%s %d %.4f\n", names[mode], blocks, ms * 1e3 / reps);
    }
  return 0;
}
