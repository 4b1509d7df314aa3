// gossip_edges: sparse Eq. 5 gossip over a directed edge list, f32.
//
//     y[d, :] = x[d, :] + sum_{e into d} w[e] * (t[src_e, :] - x[d, :])
//
// x, t, y [W, P] contiguous row-major f32; the edges in CSR form sorted by
// destination: row_ptr [W + 1], col [E] (the sources), w [E], int32 /
// int32 / f32. Honest gossip passes t = x; the attacked baseline passes
// the transmitted (corrupted) copy as t. Every delta reads the pre-mix x.
//
// Replaces the TPU kernel repro/kernels/gossip_edges.py:gossip_edges
// (body _edges_kernel): one program per column tile walking the whole
// edge list in list order with a fori_loop, all W rows resident. On a
// GPU, a scatter with atomics would add each row's deltas in an order
// that changes from run to run; here the host sorts the edges by
// destination with a stable sort (core/topology.edges_to_csr), so each
// row adds its edges in list order -- the reference's order -- and the
// kernel gathers instead of scattering. Zero-weight padding edges of the
// TPU version are not needed: entries past row_ptr[W] are never read.
//
// Arithmetic: acc = acc + w * (t - x_d) per edge, each step rounded
// separately (__fsub_rn / __fmul_rn / __fadd_rn keep nvcc from
// contracting it into an FMA), so the result is bit-equal to the plain
// version (repro_torch/kernels/ref.py:gossip_edges_ref).
//
// Bound: the function reads x (and t when t is not x) once, the CSR
// arrays once and writes y once: (2 W P [+ W P] + W + 1 + 2 E) * 4
// bytes -- 1.66 MB at W = 30, P = 6922, E = 870 (0.50 us at 3.35 TB/s);
// 113.4 MB at the W = 2,048 ring (33.9 us). Its 3 E P operations (19
// MFLOP at E = 870) are 0.27 us at 67 TFLOP/s, so bytes bound it.
//
// Design: one thread per (row d, column c), rows on the grid's y axis,
// 256 columns per block. The row's CSR entries are the same for every
// thread of a block (broadcast loads); reads of t[src, :] are coalesced
// along c. Scalar loads: a row of 6922 floats is 27,688 bytes, not a
// multiple of 16. A later version could stage a row's neighbour list in
// shared memory or give each row one warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gossip_edges_kernel(const float* __restrict__ x,
                                    const float* __restrict__ t,
                                    const int* __restrict__ row_ptr,
                                    const int* __restrict__ col,
                                    const float* __restrict__ w,
                                    float* __restrict__ y, int P) {
  const int d = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  const int64_t at = (int64_t)d * P + c;
  const float xd = x[at];
  float acc = xd;
  const int end = row_ptr[d + 1];
  for (int e = row_ptr[d]; e < end; ++e) {
    const float diff = __fsub_rn(t[(int64_t)col[e] * P + c], xd);
    acc = __fadd_rn(acc, __fmul_rn(w[e], diff));
  }
  y[at] = acc;
}

}  // namespace

// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// as an int (0 == success). The caller checks shapes, dtypes, devices and
// W <= 65535 (grid y).
extern "C" int gossip_edges_f32(const float* x, const float* t,
                                const int* row_ptr, const int* col,
                                const float* w, float* y, int W, int P,
                                void* stream) {
  if (W == 0 || P == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, W);
  gossip_edges_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, t, row_ptr, col, w, y, P);
  return (int)cudaGetLastError();
}
