// K2: the ipcache LPM alone, over a batch of addresses.
//
// Replaces: cilium_tpu/datapath/lpm.py lpm_lookup (:284), the jitted
// lpm_lookup_jit.  On the serving path the same device functions run
// inside datapath_kernel (verdict.cu); this launcher serves the
// module-level datapath/lpm.py lpm_lookup and is held to its plain
// version on its own.
// Bound: the rows' bytes (16 B of address words and 4 B of family read
// once, 4 B written) and the dependent gathers: a v4 row's up to three
// 4-byte levels, a v6 row's 32-byte index slots, one a mask probed
// (lpm.cuh).
// Design: one thread per address.  A block copies the index's group
// masks (a few, 32 B each) into shared memory while its v4 rows walk
// their levels; after one barrier every v6 lane's loop over the masks
// reads shared memory (past LPM_SMEM_GROUPS masks, global memory through
// L1).  The v6 TCAM scan this replaces read 9 words an entry for every
// v6 lane, ~2300 dependent loads at config #3's 257 entries (PERF.md).
#include "lpm.cuh"

constexpr int LPM_TPB = 256;
constexpr int LPM_SMEM_GROUPS = 64;  // 2 KB of masks a block

__global__ void __launch_bounds__(LPM_TPB)
    lpm_lookup_kernel(LpmView t, const uint32_t* ip_words,
                      const uint32_t* family, int32_t* out, int32_t n) {
  __shared__ uint4 staged[2 * LPM_SMEM_GROUPS];
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  uint32_t fam = 4;
  if (in) {
    w = *reinterpret_cast<const uint4*>(ip_words + (size_t)i * 4);
    fam = family[i];
  }
  const uint4* global_groups = reinterpret_cast<const uint4*>(t.v6_groups);
  const bool in_smem = t.n_groups <= LPM_SMEM_GROUPS;
  if (in_smem)
    for (int k = threadIdx.x; k < 2 * t.n_groups; k += blockDim.x)
      staged[k] = __ldg(global_groups + k);
  // a v4 row's walk needs no mask: it runs before the block's barrier
  int32_t got = in && fam == 4 ? lpm_v4(t, w.w) : 0;
  __syncthreads();
  if (!in) return;
  if (fam != 4) {
    const uint32_t ip[4] = {w.x, w.y, w.z, w.w};
    got = lpm_v6(t, in_smem ? staged : global_groups, ip);
  }
  out[i] = got;
}

extern "C" int lpm_lookup_launch(const LpmView* t, const uint32_t* ip_words,
                                 const uint32_t* family, int32_t* out,
                                 int32_t n, cudaStream_t stream) {
  if (n > 0) {
    lpm_lookup_kernel<<<(n + LPM_TPB - 1) / LPM_TPB, LPM_TPB, 0, stream>>>(
        *t, ip_words, family, out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t lpm_abi_size(int which) {
  return which == 0 ? sizeof(LpmView) : 0;
}
