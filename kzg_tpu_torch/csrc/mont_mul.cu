// K1: batched Montgomery multiply over BN254 Fp or Fr.
//
// Replaces T1, the one Pallas kernel on the JAX package's default path:
// kzg_tpu/fields/mont.py Field.mul -> fuse_pointwise(Field._mul_impl)
// (kzg_tpu/ops/fuse.py pl.pallas_call), a float32-matmul Montgomery product
// tiled over 256-lane VMEM blocks. Here the product is integer-only: one
// thread per lane, 17x17 32x32->64-bit multiply-accumulates into 64-bit
// columns plus 17 base-2^16 reduction rounds in registers (mont.cuh).
//
// Bound on the card: per lane it moves 3 x 17 int64 limbs (408 bytes) and
// does 2 x 289 + 17 16-bit multiply-accumulates, so at the int64 storage of
// the port's tensors it is bound by bytes, not by the integer multiply
// rate. The design keeps every intermediate in registers (nothing but the
// operands and the result touches memory) and reads limb-major so that a
// warp's loads of one limb are one contiguous 256-byte run. Storing limbs
// as 32-bit words would halve the bytes; that is later work.
#include "mont.cuh"

namespace kzg {

__global__ void __launch_bounds__(128)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, int64_t lanes, Mod M) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Fe x, y, z;
  fe_load(x, a, lanes, i);
  fe_load(y, b, lanes, i);
  mont_mul(z, x, y, M);
  fe_store(out, z, lanes, i);
}

}  // namespace kzg

// a, b, out: int64[n_limbs, lanes] contiguous on the card; mod: p, R mod p,
// n0 as uint32 (host memory). Returns cudaGetLastError() after the launch.
extern "C" int kzg_mont_mul(const int64_t* a, const int64_t* b, int64_t* out,
                            int64_t lanes, const uint32_t* mod, int n_limbs,
                            void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::Mod M = kzg::mod_from_host(mod);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::mont_mul_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(a, b, out, lanes, M);
  return (int)cudaGetLastError();
}
