// Carry-chain primitives of the field core: the PTX integer instructions
// that read and write the carry flag CC.CF, one `asm volatile` each so
// their order is kept (mul_lo / mul_hi touch no flag and stay plain C).
// A chain starts with an instruction that takes no carry in (add.cc,
// sub.cc, mad.lo.cc, ...) and no code that uses the flag runs inside one;
// ptxas maps the flag to SASS carry predicates.
//
// Built by a plain host compiler (no __CUDACC__), the same functions
// emulate the flag in a static variable, so the CPU tests run the exact
// instruction sequence of the kernels' field core (csrc/host_check.cpp).
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define PCD_FN __device__ __forceinline__
#define PCD_NOINLINE __device__ __noinline__

#define PCD_OP2(name, ins)                                              \
  PCD_FN uint32_t name(uint32_t a, uint32_t b) {                        \
    uint32_t r;                                                         \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));        \
    return r;                                                           \
  }
#define PCD_OP3(name, ins)                                              \
  PCD_FN uint32_t name(uint32_t a, uint32_t b, uint32_t c) {            \
    uint32_t r;                                                         \
    asm volatile(ins " %0, %1, %2, %3;"                                 \
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));                   \
    return r;                                                           \
  }
#else
#define PCD_FN static inline
#define PCD_NOINLINE static
static uint32_t pcd_cf;  // the emulated CC.CF

#define PCD_OP2(name, expr)                                             \
  PCD_FN uint32_t name(uint32_t a, uint32_t b) {                        \
    const uint64_t A = a, B = b, C = pcd_cf;                            \
    (void)C;                                                            \
    expr;                                                               \
  }
#define PCD_OP3(name, expr)                                             \
  PCD_FN uint32_t name(uint32_t a, uint32_t b, uint32_t c) {            \
    const uint64_t A = a, B = b, X = c, C = pcd_cf;                     \
    (void)C;                                                            \
    expr;                                                               \
  }
#endif

#if defined(__CUDACC__)
PCD_OP2(add_cc, "add.cc.u32")
PCD_OP2(addc_cc, "addc.cc.u32")
PCD_OP2(addc, "addc.u32")
PCD_OP2(sub_cc, "sub.cc.u32")
PCD_OP2(subc_cc, "subc.cc.u32")
PCD_OP2(subc, "subc.u32")
PCD_OP3(mad_lo_cc, "mad.lo.cc.u32")
PCD_OP3(mad_hi_cc, "mad.hi.cc.u32")
PCD_OP3(madc_lo_cc, "madc.lo.cc.u32")
PCD_OP3(madc_hi_cc, "madc.hi.cc.u32")
PCD_FN uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
PCD_FN uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
#else
// r = a + b (+ CF); CF = carry out
PCD_OP2(add_cc, uint64_t s = A + B; pcd_cf = (uint32_t)(s >> 32);
        return (uint32_t)s)
PCD_OP2(addc_cc, uint64_t s = A + B + C; pcd_cf = (uint32_t)(s >> 32);
        return (uint32_t)s)
PCD_OP2(addc, return (uint32_t)(A + B + C))
// r = a - b (- CF); CF = borrow out
PCD_OP2(sub_cc, pcd_cf = A < B; return (uint32_t)(A - B))
PCD_OP2(subc_cc, pcd_cf = A < B + C; return (uint32_t)(A - B - C))
PCD_OP2(subc, return (uint32_t)(A - B - C))
// r = lo/hi(a * b) + c (+ CF); CF = carry out
PCD_OP3(mad_lo_cc, uint64_t s = (uint32_t)(A * B) + X;
        pcd_cf = (uint32_t)(s >> 32); return (uint32_t)s)
PCD_OP3(mad_hi_cc, uint64_t s = ((A * B) >> 32) + X;
        pcd_cf = (uint32_t)(s >> 32); return (uint32_t)s)
PCD_OP3(madc_lo_cc, uint64_t s = (uint32_t)(A * B) + X + C;
        pcd_cf = (uint32_t)(s >> 32); return (uint32_t)s)
PCD_OP3(madc_hi_cc, uint64_t s = ((A * B) >> 32) + X + C;
        pcd_cf = (uint32_t)(s >> 32); return (uint32_t)s)
PCD_OP2(mul_lo, return (uint32_t)(A * B))
PCD_OP2(mul_hi, return (uint32_t)((A * B) >> 32))
#endif

#undef PCD_OP2
#undef PCD_OP3
