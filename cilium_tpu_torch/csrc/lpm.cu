// K2: the ipcache LPM alone, over a batch of addresses.
//
// Replaces: cilium_tpu/datapath/lpm.py lpm_lookup (:284), the jitted
// lpm_lookup_jit.  On the serving path the same device functions run
// inside datapath_kernel (verdict.cu); this launcher serves the
// module-level datapath/lpm.py lpm_lookup and is held to its plain
// version on its own.
// Bound: latency of the dependent gathers (see lpm.cuh); one thread per
// address, 16 B of address words read once, 4 B written.
#include "lpm.cuh"

__global__ void lpm_lookup_kernel(LpmView t, const uint32_t* ip_words,
                                  const uint32_t* family, int32_t* out,
                                  int32_t n) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint4 w = *reinterpret_cast<const uint4*>(ip_words + (size_t)i * 4);
  uint32_t ip[4] = {w.x, w.y, w.z, w.w};
  out[i] = lpm_lookup_row(t, ip, family[i]);
}

extern "C" int lpm_lookup_launch(const LpmView* t, const uint32_t* ip_words,
                                 const uint32_t* family, int32_t* out,
                                 int32_t n, cudaStream_t stream) {
  if (n > 0) {
    lpm_lookup_kernel<<<(n + 255) / 256, 256, 0, stream>>>(*t, ip_words,
                                                           family, out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t lpm_abi_size(int which) {
  return which == 0 ? sizeof(LpmView) : 0;
}
