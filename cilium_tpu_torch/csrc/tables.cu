// K10: an in-place dynamic_update_slice into a live table -- the engine
// of every table patch (one identity's verdict rows, its auth column,
// one LPM block or l1 cell).
//
// Replaces: cilium_tpu/datapath/loader.py _dus (:56), the jitted
// donating jax.lax.dynamic_update_slice.  The plain version is
// datapath/loader.py _dus_plain.
//
// The host does the index work (datapath/loader.py _dus_runs): it takes
// each start as jax.lax.dynamic_update_slice takes it (a negative start
// counts from the end once, then XLA clamps it into [0, dst - upd], so a
// start past the edge writes the last window that fits) and cuts the
// update into runs, pieces contiguous in both the update and the table:
// the innermost dimension, merged with outer ones wherever the update
// spans the table's full width.  The runs form a grid of up to three
// outer dimensions (counts c0, c1, c2, destination strides t0, t1, t2)
// above a base offset; run (q0, q1, q2) is the update's
// ((q0 c1 + q1) c2 + q2)-th and lands at base + q0 t0 + q1 t1 + q2 t2.
// Config #3's verdict row ([n_pol, 2, 1, 256] into [n_pol, 2, n_rows,
// 256]) is 2 n_pol runs of 256 words, an l2/l3 row one run of 256, the
// auth column n_pol runs of 1.
//
// Bound: its launch.  A patch moves a few KB (the verdict row 2 KB at
// config #3), so the least time for its bytes is ~1 ns and the kernel
// should be a bare copy at the launch floor, as a slice copy_ is.
// Design: a block row (threadIdx.y) a run, its words over threadIdx.x,
// several runs a block when runs are short; q2 from the block's x, q1
// and q0 from its y and z (strided where a count passes the grid's
// 65535).  No division: the offsets are multiply-adds of the host's
// counts and strides.  Where the run, the base, every stride and both
// pointers are multiples of 4 words, the copy moves int4 (16 bytes) a
// thread, else a word.  It runs on the stream of the serve steps (the
// loader enters it), so it lands after every step enqueued before it
// and before every step enqueued after it.
#include "views.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 65535;  // gridDim.y and .z

// T is the copy unit, 1 << SHIFT words
template <typename T, int SHIFT>
__global__ void __launch_bounds__(kThreads) dus_kernel(DusIO io) {
  const int32_t q2 = blockIdx.x * blockDim.y + threadIdx.y;
  if (q2 >= io.count[2]) return;
  const int64_t run = io.run >> SHIFT;
  T* __restrict__ dst = reinterpret_cast<T*>(io.dst);
  const T* __restrict__ upd = reinterpret_cast<const T*>(io.upd);
  for (int32_t q0 = blockIdx.z; q0 < io.count[0]; q0 += gridDim.z) {
    for (int32_t q1 = blockIdx.y; q1 < io.count[1]; q1 += gridDim.y) {
      const int64_t q =
          ((int64_t)q0 * io.count[1] + q1) * io.count[2] + q2;
      T* d = dst + ((io.base + q0 * io.stride[0] + q1 * io.stride[1] +
                     q2 * io.stride[2]) >> SHIFT);
      const T* u = upd + q * run;
      for (int64_t w = threadIdx.x; w < run; w += blockDim.x) d[w] = u[w];
    }
  }
}

}  // namespace

extern "C" int dus_launch(const DusIO* io, cudaStream_t stream) {
  const int shift = io->vec ? 2 : 0;
  const int64_t units = (int64_t)io->run >> shift;
  if (units > 0 && io->count[0] > 0 && io->count[1] > 0 &&
      io->count[2] > 0) {
    int tx = 1, ty = 1;
    while (tx < units && tx < kThreads) tx <<= 1;
    while (tx * ty < kThreads && ty < io->count[2]) ty <<= 1;
    const dim3 grid((io->count[2] + ty - 1) / ty, min(io->count[1], kMaxGrid),
                    min(io->count[0], kMaxGrid));
    if (io->vec)
      dus_kernel<int4, 2><<<grid, dim3(tx, ty), 0, stream>>>(*io);
    else
      dus_kernel<int32_t, 0><<<grid, dim3(tx, ty), 0, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t tables_abi_size(int which) {
  return which == 0 ? sizeof(DusIO) : 0;
}
