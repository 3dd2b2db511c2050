"""Write ``src_torch/repro_torch/kernels/csrc/wgmma.cuh``: the Hopper
``wgmma.mma_async`` products the flash attention kernel issues, one inline
PTX statement per shape (PTX names every accumulator register, so each
width N needs its own operand list).

    python3 src_torch/tools/gen_wgmma.py

``tests/test_torch_flash_tma.py`` checks that the committed header is what
this script writes.
"""
import os

HERE = os.path.dirname(os.path.abspath(__file__))
HEADER = os.path.join(HERE, "..", "repro_torch", "kernels", "csrc",
                      "wgmma.cuh")

#: the widths N of m64nNk16 that the kernel instantiates: S = Q K^T at
#: N = the key tile (128, or 64 at head dim 256), O += P V at N = the head
#: dim (16, 32, 64, 80, 128, 256)
WIDTHS = (16, 32, 64, 80, 128, 256)

PREAMBLE = r"""// Generated by src_torch/tools/gen_wgmma.py; do not edit by hand.
//
// Hopper warpgroup products, bf16 inputs and fp32 accumulators, one
// m64nNk16 step each (sm_90a), issued by all 128 threads of a warpgroup:
//   Wgmma<N>::ss(d, desc_a, desc_b, scale_d): d (+)= A B, A (64 x 16) and
//     B (16 x N) both read from shared memory through descriptors, both
//     K-major (no transpose);
//   Wgmma<N>::rs(d, a, desc_b): d += A B, A from registers (four bf16x2 per
//     thread, the m16n8k16 A-fragment layout of the thread's warp's 16 rows)
//     and B from shared memory MN-major (imm-trans-b = 1: B's N axis is the
//     contiguous one, as V's head dim is).
// d holds N / 2 floats per thread: d[4 j + e] is row 16 w + gid + 8 (e / 2),
// column 8 j + 2 tig + e % 2, for warp w of the warpgroup, gid = lane / 4,
// tig = lane % 4.  scale_d = 0 ignores d's old value.  The products are
// asynchronous: fence with wgmma_fence() before, commit a group after, and
// read d or overwrite a only after a wgmma_wait<> that covers it.
#pragma once
#include <cstdint>

namespace wg {

// every wgmma of a batch after the registers it reads were written
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of r across a wait
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (bytes; stored in 16-byte units) and the swizzle
// (1: 128-byte, 2: 64-byte, 3: 32-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr,
                                              uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

template <int N>
struct Wgmma;
"""


def _regs(n: int, first: int = 0) -> str:
    """``%first, ..., %(first + n - 1)``, 16 to a string literal's line."""
    names = [f"%{first + i}" for i in range(n)]
    lines = [", ".join(names[i:i + 16]) for i in range(0, n, 16)]
    return ', "\n        "'.join(lines)


def _outs(n: int) -> str:
    return ",\n          ".join(", ".join(f'"+f"(d[{i + j}])'
                                          for j in range(min(8, n - i)))
                                for i in range(0, n, 8))


def spec(N: int) -> str:
    n = N // 2
    ss = (f'"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 2}, 0;\\n"\n'
          f'        "wgmma.mma_async.sync.aligned.m64n{N}k16.f32.bf16.bf16 "\n'
          f'        "{{{_regs(n)}}}, "\n'
          f'        "%{n}, %{n + 1}, p, 1, 1, 0, 0;\\n}}\\n"')
    rs = (f'"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 5}, 0;\\n"\n'
          f'        "wgmma.mma_async.sync.aligned.m64n{N}k16.f32.bf16.bf16 "\n'
          f'        "{{{_regs(n)}}}, "\n'
          f'        "{{{_regs(4, n)}}}, %{n + 4}, p, 1, 1, 1;\\n}}\\n"')
    return f"""
template <>
struct Wgmma<{N}> {{
  static constexpr int kRegs = {n};
  static __device__ __forceinline__ void ss(float (&d)[{n}], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {{
    asm volatile(
        {ss}
        : {_outs(n)}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
  static __device__ __forceinline__ void rs(float (&d)[{n}],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {{
    asm volatile(
        {rs}
        : {_outs(n)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }}
}};
"""


def render() -> str:
    return PREAMBLE + "".join(spec(N) for N in WIDTHS) \
        + "\n}  // namespace wg\n"


def main() -> None:
    with open(HEADER, "w") as f:
        f.write(render())


if __name__ == "__main__":
    main()
