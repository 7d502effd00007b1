// pcd_native — C++ host runtime for the pcd_tpu framework.
//
// Role: the native tier the reference gets from Rust/arkworks release
// builds (SURVEY.md L1 — ark-ff/ark-ec/ark-poly are compiled Rust; this
// framework's host fallback was pure Python).  TPU remains the production
// compute path (jax/XLA/pallas); this library makes the HOST control
// plane and CPU fallback fast: key generation, toy-cycle CI chains, the
// Pippenger/NTT oracles, and full CPU proving when no accelerator is up.
//
// Scope:
//   - 320-bit Montgomery field arithmetic (5x64 limbs, CIOS) for any
//     modulus < 2^320 (covers MNT4/6-298 Fq/Fr and the toy cycle)
//   - binomial extension fields of degree 2/3 (G2 coordinate fields)
//   - short-Weierstrass Jacobian EC ops (general a), batch-affine output
//   - Pippenger MSM (bucket windows over the actual scalar bit length)
//   - fixed-base windowed batch scalar-mul (key generation)
//   - mixed-radix NTT over smooth-order domains + geometric scaling
//
// ABI: plain C, arrays of uint64 limbs (little-endian, canonical — NOT
// Montgomery), driven from Python via ctypes (pcd_tpu/native/__init__.py).
// Build: g++ -O3 -shared -fPIC pcd_native.cpp -o libpcdnative.so
//
// The port's copy of `pcd_tpu/native/pcd_native.cpp`; the pcd_tpu paths
// named here are the JAX package's modules.

#include <cstdint>
#include <cstring>
#include <vector>
#include <mutex>
#include <thread>
#include <algorithm>
#include <memory>
#include <atomic>

static int hw_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? (int)n : 1;
}

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef uint32_t u32;
typedef int32_t i32;
typedef uint8_t u8;

static const int NL = 5; // limbs per base-field element (320 bits)

// ---------------------------------------------------------------- field
struct Fp {
    u64 v[NL];
};

static inline bool fp_is_zero(const Fp &a) {
    u64 r = 0;
    for (int i = 0; i < NL; i++) r |= a.v[i];
    return r == 0;
}

static inline int fp_cmp(const Fp &a, const Fp &b) {
    for (int i = NL - 1; i >= 0; i--) {
        if (a.v[i] != b.v[i]) return a.v[i] < b.v[i] ? -1 : 1;
    }
    return 0;
}

struct FieldCtx {
    Fp mod;        // modulus p
    Fp r2;         // R^2 mod p (R = 2^320)
    Fp one_mont;   // R mod p
    u64 n0inv;     // -p^{-1} mod 2^64
    int bits;      // p.bit_length()
};

static inline void fp_sub_raw(const Fp &a, const Fp &b, Fp &out) {
    u128 borrow = 0;
    for (int i = 0; i < NL; i++) {
        u128 d = (u128)a.v[i] - b.v[i] - (u64)borrow;
        out.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline bool fp_add_raw(const Fp &a, const Fp &b, Fp &out) {
    u128 carry = 0;
    for (int i = 0; i < NL; i++) {
        u128 s = (u128)a.v[i] + b.v[i] + (u64)carry;
        out.v[i] = (u64)s;
        carry = s >> 64;
    }
    return carry != 0;
}

static inline void fp_add(const FieldCtx &C, const Fp &a, const Fp &b, Fp &out) {
    bool carry = fp_add_raw(a, b, out);
    if (carry || fp_cmp(out, C.mod) >= 0) {
        Fp t;
        fp_sub_raw(out, C.mod, t);
        out = t;
    }
}

static inline void fp_sub(const FieldCtx &C, const Fp &a, const Fp &b, Fp &out) {
    if (fp_cmp(a, b) >= 0) {
        fp_sub_raw(a, b, out);
    } else {
        Fp t;
        fp_sub_raw(b, a, t);
        fp_sub_raw(C.mod, t, out);
    }
}

static inline void fp_neg(const FieldCtx &C, const Fp &a, Fp &out) {
    if (fp_is_zero(a)) { out = a; return; }
    fp_sub_raw(C.mod, a, out);
}

// CIOS Montgomery multiplication: out = a*b*R^{-1} mod p
static void fp_mont_mul(const FieldCtx &C, const Fp &a, const Fp &b, Fp &out) {
    u64 t[NL + 2] = {0};
    for (int i = 0; i < NL; i++) {
        // t += a[i] * b
        u128 carry = 0;
        for (int j = 0; j < NL; j++) {
            u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + (u64)carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[NL] + (u64)carry;
        t[NL] = (u64)s;
        t[NL + 1] = (u64)(s >> 64);
        // m = t[0] * n0inv mod 2^64; t += m*p; t >>= 64
        u64 m = t[0] * C.n0inv;
        carry = ((u128)t[0] + (u128)m * C.mod.v[0]) >> 64;
        for (int j = 1; j < NL; j++) {
            u128 s2 = (u128)t[j] + (u128)m * C.mod.v[j] + (u64)carry;
            t[j - 1] = (u64)s2;
            carry = s2 >> 64;
        }
        s = (u128)t[NL] + (u64)carry;
        t[NL - 1] = (u64)s;
        t[NL] = t[NL + 1] + (u64)(s >> 64);
        t[NL + 1] = 0;
    }
    Fp r;
    for (int i = 0; i < NL; i++) r.v[i] = t[i];
    if (t[NL] || fp_cmp(r, C.mod) >= 0) {
        Fp q;
        fp_sub_raw(r, C.mod, q);
        out = q;
    } else {
        out = r;
    }
}

static inline void fp_to_mont(const FieldCtx &C, const Fp &a, Fp &out) {
    fp_mont_mul(C, a, C.r2, out);
}

static inline void fp_from_mont(const FieldCtx &C, const Fp &a, Fp &out) {
    Fp one = {{1, 0, 0, 0, 0}};
    fp_mont_mul(C, a, one, out);
}

// a^e mod p (Montgomery in/out), e given as limbs
static void fp_pow(const FieldCtx &C, const Fp &a, const Fp &e, Fp &out) {
    Fp acc = C.one_mont;
    Fp base = a;
    for (int i = 0; i < NL; i++) {
        u64 w = e.v[i];
        for (int b = 0; b < 64; b++) {
            if (w & 1) fp_mont_mul(C, acc, base, acc);
            fp_mont_mul(C, base, base, base);
            w >>= 1;
        }
    }
    out = acc;
}

static void fp_inv(const FieldCtx &C, const Fp &a, Fp &out) {
    // Fermat: a^{p-2}
    Fp e;
    Fp two = {{2, 0, 0, 0, 0}};
    fp_sub_raw(C.mod, two, e);
    fp_pow(C, a, e, out);
}

// ------------------------------------------------------------- ext field
// element = deg coefficients, x^deg = nr (nr in base field, Montgomery)
struct ExtCtx {
    FieldCtx base;
    int deg;       // 1, 2 or 3
    Fp nr;         // Montgomery
};

struct Ext {
    Fp c[3];
};

static inline void ext_zero(Ext &o) { std::memset(&o, 0, sizeof(Ext)); }

static inline bool ext_is_zero(const ExtCtx &E, const Ext &a) {
    for (int i = 0; i < E.deg; i++)
        if (!fp_is_zero(a.c[i])) return false;
    return true;
}

static inline void ext_add(const ExtCtx &E, const Ext &a, const Ext &b, Ext &o) {
    for (int i = 0; i < E.deg; i++) fp_add(E.base, a.c[i], b.c[i], o.c[i]);
    for (int i = E.deg; i < 3; i++) std::memset(o.c[i].v, 0, sizeof(Fp));
}

static inline void ext_sub(const ExtCtx &E, const Ext &a, const Ext &b, Ext &o) {
    for (int i = 0; i < E.deg; i++) fp_sub(E.base, a.c[i], b.c[i], o.c[i]);
    for (int i = E.deg; i < 3; i++) std::memset(o.c[i].v, 0, sizeof(Fp));
}

static inline void ext_neg(const ExtCtx &E, const Ext &a, Ext &o) {
    for (int i = 0; i < E.deg; i++) fp_neg(E.base, a.c[i], o.c[i]);
    for (int i = E.deg; i < 3; i++) std::memset(o.c[i].v, 0, sizeof(Fp));
}

static void ext_mul(const ExtCtx &E, const Ext &a, const Ext &b, Ext &o) {
    const FieldCtx &C = E.base;
    if (E.deg == 1) {
        fp_mont_mul(C, a.c[0], b.c[0], o.c[0]);
        std::memset(o.c[1].v, 0, sizeof(Fp));
        std::memset(o.c[2].v, 0, sizeof(Fp));
        return;
    }
    Fp prod[5];
    int np = 2 * E.deg - 1;
    for (int k = 0; k < np; k++) std::memset(prod[k].v, 0, sizeof(Fp));
    Fp t;
    for (int i = 0; i < E.deg; i++) {
        for (int j = 0; j < E.deg; j++) {
            fp_mont_mul(C, a.c[i], b.c[j], t);
            fp_add(C, prod[i + j], t, prod[i + j]);
        }
    }
    // fold x^{deg+t} = nr * x^t
    for (int k = np - 1; k >= E.deg; k--) {
        fp_mont_mul(C, prod[k], E.nr, t);
        fp_add(C, prod[k - E.deg], t, prod[k - E.deg]);
    }
    for (int i = 0; i < E.deg; i++) o.c[i] = prod[i];
    for (int i = E.deg; i < 3; i++) std::memset(o.c[i].v, 0, sizeof(Fp));
}

static inline void ext_sqr(const ExtCtx &E, const Ext &a, Ext &o) {
    ext_mul(E, a, a, o);
}

static void ext_inv(const ExtCtx &E, const Ext &a, Ext &o) {
    const FieldCtx &C = E.base;
    if (E.deg == 1) {
        fp_inv(C, a.c[0], o.c[0]);
        std::memset(o.c[1].v, 0, sizeof(Fp));
        std::memset(o.c[2].v, 0, sizeof(Fp));
        return;
    }
    if (E.deg == 2) {
        // (a0 - a1 u) / (a0^2 - nr a1^2)
        Fp d, t0, t1;
        fp_mont_mul(C, a.c[0], a.c[0], t0);
        fp_mont_mul(C, a.c[1], a.c[1], t1);
        fp_mont_mul(C, t1, E.nr, t1);
        fp_sub(C, t0, t1, d);
        fp_inv(C, d, d);
        fp_mont_mul(C, a.c[0], d, o.c[0]);
        Fp na1;
        fp_neg(C, a.c[1], na1);
        fp_mont_mul(C, na1, d, o.c[1]);
        std::memset(o.c[2].v, 0, sizeof(Fp));
        return;
    }
    // deg 3, u^3 = nr:
    //   v0 = a0^2 - nr a1 a2; v1 = nr a2^2 - a0 a1; v2 = a1^2 - a0 a2
    //   D  = a0 v0 + nr a1 v2 + nr a2 v1;   inv = (v0, v1, v2) / D
    Fp v0, v1, v2, t, u, D;
    fp_mont_mul(C, a.c[0], a.c[0], v0);
    fp_mont_mul(C, a.c[1], a.c[2], t);
    fp_mont_mul(C, t, E.nr, t);
    fp_sub(C, v0, t, v0);
    fp_mont_mul(C, a.c[2], a.c[2], v1);
    fp_mont_mul(C, v1, E.nr, v1);
    fp_mont_mul(C, a.c[0], a.c[1], t);
    fp_sub(C, v1, t, v1);
    fp_mont_mul(C, a.c[1], a.c[1], v2);
    fp_mont_mul(C, a.c[0], a.c[2], t);
    fp_sub(C, v2, t, v2);
    fp_mont_mul(C, a.c[0], v0, D);
    fp_mont_mul(C, a.c[1], v2, t);
    fp_mont_mul(C, t, E.nr, t);
    fp_add(C, D, t, D);
    fp_mont_mul(C, a.c[2], v1, u);
    fp_mont_mul(C, u, E.nr, u);
    fp_add(C, D, u, D);
    fp_inv(C, D, D);
    fp_mont_mul(C, v0, D, o.c[0]);
    fp_mont_mul(C, v1, D, o.c[1]);
    fp_mont_mul(C, v2, D, o.c[2]);
}

// ------------------------------------------------------------------ curve
struct CurveCtx {
    ExtCtx E;
    Ext a;         // Montgomery
    Ext b;
    bool a_is_zero;
};

// Jacobian point: (X, Y, Z), affine = (X/Z^2, Y/Z^3); Z == 0 => infinity
struct Jac {
    Ext X, Y, Z;
};

static inline bool jac_is_inf(const CurveCtx &K, const Jac &P) {
    return ext_is_zero(K.E, P.Z);
}

static inline void jac_set_inf(Jac &P) {
    ext_zero(P.X);
    ext_zero(P.Y);
    ext_zero(P.Z);
}

// general-a Jacobian doubling
static void jac_double(const CurveCtx &K, const Jac &P, Jac &O) {
    const ExtCtx &E = K.E;
    if (jac_is_inf(K, P) || ext_is_zero(E, P.Y)) { jac_set_inf(O); return; }
    Ext XX, YY, YYYY, ZZ, S, M, T, t, u;
    ext_sqr(E, P.X, XX);
    ext_sqr(E, P.Y, YY);
    ext_sqr(E, YY, YYYY);
    ext_sqr(E, P.Z, ZZ);
    // S = 2*((X+YY)^2 - XX - YYYY)
    ext_add(E, P.X, YY, t);
    ext_sqr(E, t, t);
    ext_sub(E, t, XX, t);
    ext_sub(E, t, YYYY, t);
    ext_add(E, t, t, S);
    // M = 3*XX + a*ZZ^2
    ext_add(E, XX, XX, M);
    ext_add(E, M, XX, M);
    if (!K.a_is_zero) {
        ext_sqr(E, ZZ, u);
        ext_mul(E, u, K.a, u);
        ext_add(E, M, u, M);
    }
    // X3 = M^2 - 2S
    ext_sqr(E, M, T);
    ext_sub(E, T, S, T);
    ext_sub(E, T, S, T);
    // Z3 = (Y+Z)^2 - YY - ZZ   (compute BEFORE overwriting Y)
    Ext Z3;
    ext_add(E, P.Y, P.Z, Z3);
    ext_sqr(E, Z3, Z3);
    ext_sub(E, Z3, YY, Z3);
    ext_sub(E, Z3, ZZ, Z3);
    // Y3 = M*(S - T) - 8*YYYY
    ext_sub(E, S, T, t);
    ext_mul(E, M, t, t);
    ext_add(E, YYYY, YYYY, u);
    ext_add(E, u, u, u);
    ext_add(E, u, u, u);
    ext_sub(E, t, u, O.Y);
    O.X = T;
    O.Z = Z3;
}

// full Jacobian addition (handles doubling/infinity via branches)
static void jac_add(const CurveCtx &K, const Jac &P, const Jac &Q, Jac &O) {
    const ExtCtx &E = K.E;
    if (jac_is_inf(K, P)) { O = Q; return; }
    if (jac_is_inf(K, Q)) { O = P; return; }
    Ext Z1Z1, Z2Z2, U1, U2, S1, S2, t;
    ext_sqr(E, P.Z, Z1Z1);
    ext_sqr(E, Q.Z, Z2Z2);
    ext_mul(E, P.X, Z2Z2, U1);
    ext_mul(E, Q.X, Z1Z1, U2);
    ext_mul(E, Q.Z, Z2Z2, t);
    ext_mul(E, P.Y, t, S1);
    ext_mul(E, P.Z, Z1Z1, t);
    ext_mul(E, Q.Y, t, S2);
    Ext H, R;
    ext_sub(E, U2, U1, H);
    ext_sub(E, S2, S1, R);
    if (ext_is_zero(E, H)) {
        if (ext_is_zero(E, R)) { jac_double(K, P, O); return; }
        jac_set_inf(O);
        return;
    }
    Ext HH, HHH, V;
    ext_sqr(E, H, HH);
    ext_mul(E, H, HH, HHH);
    ext_mul(E, U1, HH, V);
    // X3 = R^2 - HHH - 2V
    Ext X3, Y3, Z3;
    ext_sqr(E, R, X3);
    ext_sub(E, X3, HHH, X3);
    ext_sub(E, X3, V, X3);
    ext_sub(E, X3, V, X3);
    // Y3 = R*(V - X3) - S1*HHH
    ext_sub(E, V, X3, t);
    ext_mul(E, R, t, Y3);
    ext_mul(E, S1, HHH, t);
    ext_sub(E, Y3, t, Y3);
    // Z3 = Z1*Z2*H
    ext_mul(E, P.Z, Q.Z, Z3);
    ext_mul(E, Z3, H, Z3);
    O.X = X3;
    O.Y = Y3;
    O.Z = Z3;
}

// mixed addition: Q affine (Z = 1)
static void jac_add_affine(const CurveCtx &K, const Jac &P,
                           const Ext &qx, const Ext &qy, Jac &O) {
    const ExtCtx &E = K.E;
    if (jac_is_inf(K, P)) {
        O.X = qx;
        O.Y = qy;
        // Z = 1 (Montgomery one in coefficient 0)
        ext_zero(O.Z);
        O.Z.c[0] = E.base.one_mont;
        return;
    }
    Ext Z1Z1, U2, S2, t;
    ext_sqr(E, P.Z, Z1Z1);
    ext_mul(E, qx, Z1Z1, U2);
    ext_mul(E, P.Z, Z1Z1, t);
    ext_mul(E, qy, t, S2);
    Ext H, R;
    ext_sub(E, U2, P.X, H);
    ext_sub(E, S2, P.Y, R);
    if (ext_is_zero(E, H)) {
        if (ext_is_zero(E, R)) { jac_double(K, P, O); return; }
        jac_set_inf(O);
        return;
    }
    Ext HH, HHH, V;
    ext_sqr(E, H, HH);
    ext_mul(E, H, HH, HHH);
    ext_mul(E, P.X, HH, V);
    Ext X3, Y3, Z3;
    ext_sqr(E, R, X3);
    ext_sub(E, X3, HHH, X3);
    ext_sub(E, X3, V, X3);
    ext_sub(E, X3, V, X3);
    ext_sub(E, V, X3, t);
    ext_mul(E, R, t, Y3);
    ext_mul(E, P.Y, HHH, t);
    ext_sub(E, Y3, t, Y3);
    ext_mul(E, P.Z, H, Z3);
    O.X = X3;
    O.Y = Y3;
    O.Z = Z3;
}

static void jac_neg(const CurveCtx &K, Jac &P) {
    ext_neg(K.E, P.Y, P.Y);
}

// Jacobian -> affine (single point)
static bool jac_to_affine(const CurveCtx &K, const Jac &P, Ext &ax, Ext &ay) {
    const ExtCtx &E = K.E;
    if (jac_is_inf(K, P)) return false; // infinity
    Ext zi, zi2, zi3;
    ext_inv(E, P.Z, zi);
    ext_sqr(E, zi, zi2);
    ext_mul(E, zi, zi2, zi3);
    ext_mul(E, P.X, zi2, ax);
    ext_mul(E, P.Y, zi3, ay);
    return true;
}

// ----------------------------------------------------------------- state
static std::vector<FieldCtx *> g_fields;
static std::vector<CurveCtx *> g_curves;
static std::mutex g_lock;

static void field_init(FieldCtx &C, const u64 *mod) {
    std::memcpy(C.mod.v, mod, NL * 8);
    // n0inv = -p^{-1} mod 2^64 (Newton)
    u64 p0 = C.mod.v[0];
    u64 inv = 1;
    for (int i = 0; i < 6; i++) inv *= 2 - p0 * inv;
    C.n0inv = (u64)(0 - inv);
    // R mod p by long division of 2^320: repeated doubling of (2^319 mod p)
    // simpler: start with 1 and double 320 times mod p
    Fp r = {{1, 0, 0, 0, 0}};
    for (int i = 0; i < 320; i++) {
        Fp s;
        bool carry = fp_add_raw(r, r, s);
        if (carry || fp_cmp(s, C.mod) >= 0) fp_sub_raw(s, C.mod, s);
        r = s;
    }
    C.one_mont = r;
    // R^2 mod p: double one_mont 320 more times
    Fp r2 = r;
    for (int i = 0; i < 320; i++) {
        Fp s;
        bool carry = fp_add_raw(r2, r2, s);
        if (carry || fp_cmp(s, C.mod) >= 0) fp_sub_raw(s, C.mod, s);
        r2 = s;
    }
    C.r2 = r2;
    int bits = 0;
    for (int i = NL - 1; i >= 0 && !bits; i--) {
        if (C.mod.v[i]) {
            bits = i * 64 + 64 - __builtin_clzll(C.mod.v[i]);
        }
    }
    C.bits = bits;
}

extern "C" long pcd_field_new(const u64 *mod) {
    std::lock_guard<std::mutex> g(g_lock);
    FieldCtx *C = new FieldCtx();
    field_init(*C, mod);
    g_fields.push_back(C);
    return (long)g_fields.size() - 1;
}

// deg in {1,2,3}; nr: base elem (canonical); a,b: deg coeffs each (canonical)
extern "C" long pcd_curve_new(const u64 *mod, int deg, const u64 *nr,
                              const u64 *a, const u64 *b) {
    std::lock_guard<std::mutex> g(g_lock);
    CurveCtx *K = new CurveCtx();
    field_init(K->E.base, mod);
    K->E.deg = deg;
    Fp nr_c;
    std::memcpy(nr_c.v, nr, NL * 8);
    fp_to_mont(K->E.base, nr_c, K->E.nr);
    ext_zero(K->a);
    ext_zero(K->b);
    for (int i = 0; i < deg; i++) {
        Fp t;
        std::memcpy(t.v, a + i * NL, NL * 8);
        fp_to_mont(K->E.base, t, K->a.c[i]);
        std::memcpy(t.v, b + i * NL, NL * 8);
        fp_to_mont(K->E.base, t, K->b.c[i]);
    }
    K->a_is_zero = ext_is_zero(K->E, K->a);
    g_curves.push_back(K);
    return (long)g_curves.size() - 1;
}

// --- helpers: canonical <-> Montgomery ext load/store -------------------
static void ext_load(const ExtCtx &E, const u64 *src, Ext &o) {
    ext_zero(o);
    for (int i = 0; i < E.deg; i++) {
        Fp t;
        std::memcpy(t.v, src + i * NL, NL * 8);
        fp_to_mont(E.base, t, o.c[i]);
    }
}

static void ext_store(const ExtCtx &E, const Ext &a, u64 *dst) {
    for (int i = 0; i < E.deg; i++) {
        Fp t;
        fp_from_mont(E.base, a.c[i], t);
        std::memcpy(dst + i * NL, t.v, NL * 8);
    }
}

static inline int scalar_bits_of(const u64 *s, int nl) {
    for (int i = nl - 1; i >= 0; i--) {
        if (s[i]) return i * 64 + 64 - __builtin_clzll(s[i]);
    }
    return 0;
}

// ------------------------------------------------------------------- MSM
//
// Signed-digit Pippenger with batch-affine bucket accumulation:
//   - scalars are recoded to digits d in [-2^(c-1), 2^(c-1)-1], so a
//     window needs 2^(c-1) buckets (negative digits negate the gathered
//     point's y — one field negation vs doubling the bucket count);
//   - per window, points are counting-sorted into bucket segments and
//     summed by pairing rounds of AFFINE additions whose inversions are
//     shared via Montgomery's batch-inversion trick: ~6 field muls per
//     point vs ~11 for a mixed Jacobian add, and buckets stay affine so
//     the suffix-sum reduction starts from mixed adds;
//   - the window size is chosen by a mul-count cost model instead of a
//     fixed heuristic.
// (This is the host tier of SURVEY.md D4; the device tier is the JAX
// sort+segmented-scan Pippenger in pcd_tpu/ops/msm_tensor.py.)

// batch inversion (Montgomery's trick); v[i] != 0 required, in/out Mont.
static void ext_batch_inv(const ExtCtx &E, Ext *v, long n, Ext *scratch) {
    if (n <= 0) return;
    scratch[0] = v[0];
    for (long i = 1; i < n; i++) ext_mul(E, scratch[i - 1], v[i], scratch[i]);
    Ext acc;
    ext_inv(E, scratch[n - 1], acc);
    for (long i = n - 1; i > 0; i--) {
        Ext t;
        ext_mul(E, acc, scratch[i - 1], t); // 1/v[i]
        ext_mul(E, acc, v[i], acc);         // strip v[i]
        v[i] = t;
    }
    v[0] = acc;
}

// marker for "affine infinity" inside the bucket work arrays: x = y = 0
// is never on y^2 = x^3 + ax + b with b != 0 (all curves in this stack).
static inline bool aff_is_marker(const ExtCtx &E, const Ext &x, const Ext &y) {
    return ext_is_zero(E, x) && ext_is_zero(E, y);
}

// points: affine coords canonical, xs/ys each npts*deg*NL u64; inf: npts u8
// scalars: npts*NL; out: 2*deg*NL u64 (affine x,y) + out_inf flag
extern "C" int pcd_msm(long curve_h, long npts, const u64 *xs, const u64 *ys,
                       const unsigned char *inf, const u64 *scalars,
                       u64 *out_xy, unsigned char *out_inf) {
    if (curve_h < 0 || curve_h >= (long)g_curves.size()) return -1;
    const CurveCtx &K = *g_curves[curve_h];
    const ExtCtx &E = K.E;
    const int ds = E.deg * NL;
    const int nthreads = hw_threads();

    // ---- phase 0 (threaded over points): Montgomery load + max bits
    std::vector<Ext> PX(npts), PY(npts);
    std::vector<int> tmax(nthreads, 1);
    {
        auto loader = [&](int tid) {
            int mb = 1;
            for (long i = tid; i < npts; i += nthreads) {
                ext_load(E, xs + i * ds, PX[i]);
                ext_load(E, ys + i * ds, PY[i]);
                int b = scalar_bits_of(scalars + i * NL, NL);
                if (b > mb) mb = b;
            }
            tmax[tid] = mb;
        };
        std::vector<std::thread> ts;
        for (int t = 1; t < nthreads; t++) ts.emplace_back(loader, t);
        loader(0);
        for (auto &t : ts) t.join();
    }
    int maxbits = 1;
    for (int t = 0; t < nthreads; t++)
        if (tmax[t] > maxbits) maxbits = tmax[t];

    // ---- window size by mul-count cost model (signed digits):
    // accumulation ~6 muls/point/window, reduction ~28 muls/bucket/window
    int c = 2;
    double best = 1e300;
    for (int cc = 2; cc <= 20; cc++) {
        double nw = (double)((maxbits + cc - 1) / cc + 1);
        double cost = nw * (6.0 * (double)npts + 28.0 * (double)(1L << (cc - 1)));
        if (cost < best) { best = cost; c = cc; }
    }
    const int nwin = (maxbits + c - 1) / c + 1; // +1: signed carry-out
    const long half = 1L << (c - 1);
    const u64 full = 1UL << c;

    // ---- phase 1 (threaded over points): signed-digit recode
    // dig[w*npts+i] = mag | (sign << 31), mag <= half
    std::vector<uint32_t> dig((size_t)nwin * npts);
    {
        auto recoder = [&](int tid) {
            for (long i = tid; i < npts; i += nthreads) {
                const u64 *s = scalars + i * NL;
                const bool skip = inf && inf[i];
                u64 carry = 0;
                for (int w = 0; w < nwin; w++) {
                    u64 d;
                    if (skip) { dig[(size_t)w * npts + i] = 0; continue; }
                    const int shift = w * c;
                    const int limb = shift / 64, off = shift % 64;
                    if (limb >= NL) d = carry;
                    else {
                        d = s[limb] >> off;
                        if (off && limb + 1 < NL) d |= s[limb + 1] << (64 - off);
                        d = (d & (full - 1)) + carry;
                    }
                    if (d >= (u64)half) {
                        // d - full in [-half, 0]; store |d - full|
                        dig[(size_t)w * npts + i] =
                            (uint32_t)(full - d) | 0x80000000u;
                        carry = 1;
                    } else {
                        dig[(size_t)w * npts + i] = (uint32_t)d;
                        carry = 0;
                    }
                }
            }
        };
        std::vector<std::thread> ts;
        for (int t = 1; t < nthreads; t++) ts.emplace_back(recoder, t);
        recoder(0);
        for (auto &t : ts) t.join();
    }

    // ---- phase 2 (threaded over windows): batch-affine bucket sums
    std::vector<Jac> wsums(nwin);
    const int wthreads = std::min(nthreads, nwin);
    auto worker = [&](int tid) {
        std::vector<Ext> ax(npts), ay(npts);
        std::vector<Ext> den(npts / 2 + 1), scratch(npts / 2 + 1);
        std::vector<long> start(half + 1), len(half + 1), fill(half + 1);
        std::vector<long> p1(npts / 2 + 1), pseg(npts / 2 + 1);
        std::vector<uint8_t> pdbl(npts / 2 + 1);
        for (int w = tid; w < nwin; w += wthreads) {
            const uint32_t *dw = dig.data() + (size_t)w * npts;
            // counting sort into bucket segments by |digit|
            std::fill(len.begin(), len.end(), 0);
            for (long i = 0; i < npts; i++) {
                uint32_t m = dw[i] & 0x7FFFFFFFu;
                if (m) len[m]++;
            }
            long acc_pos = 0;
            for (long m = 1; m <= half; m++) {
                start[m] = acc_pos;
                fill[m] = acc_pos;
                acc_pos += len[m];
            }
            for (long i = 0; i < npts; i++) {
                uint32_t dv = dw[i];
                uint32_t m = dv & 0x7FFFFFFFu;
                if (!m) continue;
                long k = fill[m]++;
                ax[k] = PX[i];
                if (dv & 0x80000000u) ext_neg(E, PY[i], ay[k]);
                else ay[k] = PY[i];
            }
            // pairing rounds with shared batch inversion
            bool again = true;
            while (again) {
                again = false;
                long npairs = 0;
                for (long m = 1; m <= half; m++) {
                    long L = len[m], s0 = start[m];
                    if (L < 2) continue;
                    for (long j = 0; j + 1 < L; j += 2) {
                        const Ext &x1 = ax[s0 + j], &y1 = ay[s0 + j];
                        const Ext &x2 = ax[s0 + j + 1], &y2 = ay[s0 + j + 1];
                        Ext d;
                        ext_sub(E, x2, x1, d);
                        if (ext_is_zero(E, d)) {
                            Ext sy;
                            ext_add(E, y1, y2, sy);
                            if (ext_is_zero(E, sy)) {
                                // P + (-P) = infinity: mark both inputs so
                                // the apply pass emits the marker
                                pdbl[npairs] = 2;
                                // dummy nonzero value keeps batch_inv happy
                                ext_zero(den[npairs]);
                                den[npairs].c[0] = E.base.one_mont;
                            } else {
                                // doubling: den = 2*y1
                                pdbl[npairs] = 1;
                                ext_add(E, y1, y1, den[npairs]);
                            }
                        } else {
                            pdbl[npairs] = 0;
                            den[npairs] = d;
                        }
                        p1[npairs] = s0 + j;
                        pseg[npairs] = m;
                        npairs++;
                    }
                }
                if (!npairs) break;
                ext_batch_inv(E, den.data(), npairs, scratch.data());
                // apply pass: results written to the segment front
                // (pair k of segment m reads s0+2k, s0+2k+1 and writes
                // s0+k — strictly behind unread inputs)
                long k_in_seg = 0;
                long prev_seg = -1;
                for (long q = 0; q < npairs; q++) {
                    long m = pseg[q];
                    if (m != prev_seg) { prev_seg = m; k_in_seg = 0; }
                    long s0 = start[m];
                    long i1 = p1[q];
                    long out = s0 + k_in_seg;
                    k_in_seg++;
                    if (pdbl[q] == 2) { // infinity marker
                        ext_zero(ax[out]);
                        ext_zero(ay[out]);
                        continue;
                    }
                    Ext lam, t, x3, y3;
                    if (pdbl[q] == 1) {
                        // lambda = (3 x1^2 + a) / (2 y1)
                        ext_sqr(E, ax[i1], t);
                        Ext t3;
                        ext_add(E, t, t, t3);
                        ext_add(E, t3, t, t3);
                        if (!K.a_is_zero) ext_add(E, t3, K.a, t3);
                        ext_mul(E, t3, den[q], lam);
                    } else {
                        Ext dy;
                        ext_sub(E, ay[i1 + 1], ay[i1], dy);
                        ext_mul(E, dy, den[q], lam);
                    }
                    ext_sqr(E, lam, x3);
                    ext_sub(E, x3, ax[i1], x3);
                    ext_sub(E, x3, ax[i1 + 1], x3);
                    ext_sub(E, ax[i1], x3, t);
                    ext_mul(E, lam, t, y3);
                    ext_sub(E, y3, ay[i1], y3);
                    ax[out] = x3;
                    ay[out] = y3;
                }
                // compact: move odd leftovers, drop infinity markers
                for (long m = 1; m <= half; m++) {
                    long L = len[m], s0 = start[m];
                    if (L < 2) continue;
                    long np = L / 2;
                    long newL = np;
                    if (L & 1) {
                        ax[s0 + np] = ax[s0 + L - 1];
                        ay[s0 + np] = ay[s0 + L - 1];
                        newL++;
                    }
                    long wpos = s0;
                    for (long j = 0; j < newL; j++) {
                        if (aff_is_marker(E, ax[s0 + j], ay[s0 + j])) continue;
                        if (wpos != s0 + j) {
                            ax[wpos] = ax[s0 + j];
                            ay[wpos] = ay[s0 + j];
                        }
                        wpos++;
                    }
                    len[m] = wpos - s0;
                    if (len[m] > 1) again = true;
                }
            }
            // suffix-sum reduction over (now affine, 0/1-entry) buckets
            Jac running, wsum;
            jac_set_inf(running);
            jac_set_inf(wsum);
            for (long m = half; m >= 1; m--) {
                if (len[m])
                    jac_add_affine(K, running, ax[start[m]], ay[start[m]],
                                   running);
                jac_add(K, wsum, running, wsum);
            }
            wsums[w] = wsum;
        }
    };
    if (wthreads > 1) {
        std::vector<std::thread> ts;
        for (int t = 0; t < wthreads; t++) ts.emplace_back(worker, t);
        for (auto &t : ts) t.join();
    } else {
        worker(0);
    }
    Jac total;
    jac_set_inf(total);
    for (int w = nwin - 1; w >= 0; w--) {
        if (w != nwin - 1) {
            for (int k = 0; k < c; k++) jac_double(K, total, total);
        }
        jac_add(K, total, wsums[w], total);
    }
    Ext ax, ay;
    if (!jac_to_affine(K, total, ax, ay)) {
        *out_inf = 1;
        std::memset(out_xy, 0, 2 * ds * 8);
        return 0;
    }
    *out_inf = 0;
    ext_store(E, ax, out_xy);
    ext_store(E, ay, out_xy + ds);
    return 0;
}

// --------------------------------------------------- fixed-base batch mul
// base affine (canonical); scalars nsc*NL; outputs affine + inf flags.
// max_bits bounds the table size.
extern "C" int pcd_fixed_base(long curve_h, const u64 *base_xy, int max_bits,
                              long nsc, const u64 *scalars, u64 *out_xs,
                              u64 *out_ys, unsigned char *out_inf) {
    if (curve_h < 0 || curve_h >= (long)g_curves.size()) return -1;
    const CurveCtx &K = *g_curves[curve_h];
    const ExtCtx &E = K.E;
    const int ds = E.deg * NL;
    const int W = 8;
    const int nwin = (max_bits + W - 1) / W;

    Ext bx, by;
    ext_load(E, base_xy, bx);
    ext_load(E, base_xy + ds, by);
    // tables[w][d] = d * 2^{8w} * G, Jacobian
    std::vector<std::vector<Jac>> tables(nwin);
    Jac cur;
    cur.X = bx;
    cur.Y = by;
    ext_zero(cur.Z);
    cur.Z.c[0] = E.base.one_mont;
    for (int w = 0; w < nwin; w++) {
        tables[w].resize(1 << W);
        jac_set_inf(tables[w][0]);
        for (int d = 1; d < (1 << W); d++) {
            jac_add(K, tables[w][d - 1], cur, tables[w][d]);
        }
        for (int k = 0; k < W; k++) jac_double(K, cur, cur);
    }
    // per-scalar accumulate (threaded) + batch affine conversion
    std::vector<Jac> res(nsc);
    const int nthreads = std::min((long)hw_threads(), std::max(1L, nsc / 64));
    auto worker = [&](int tid) {
        for (long i = tid; i < nsc; i += nthreads) {
            Jac acc;
            jac_set_inf(acc);
            const u64 *s = scalars + i * NL;
            for (int w = 0; w < nwin; w++) {
                int shift = w * W;
                int limb = shift / 64, off = shift % 64;
                u64 d = s[limb] >> off;
                if (off && limb + 1 < NL) d |= s[limb + 1] << (64 - off);
                d &= (1 << W) - 1;
                if (d) jac_add(K, acc, tables[w][d], acc);
            }
            res[i] = acc;
        }
    };
    if (nthreads > 1) {
        std::vector<std::thread> ts;
        for (int t = 0; t < nthreads; t++) ts.emplace_back(worker, t);
        for (auto &t : ts) t.join();
    } else {
        worker(0);
    }
    // batch inversion of Z (Montgomery's trick) over the ext field
    std::vector<Ext> pref(nsc);
    Ext run;
    ext_zero(run);
    run.c[0] = E.base.one_mont;
    for (long i = 0; i < nsc; i++) {
        pref[i] = run;
        if (!jac_is_inf(K, res[i])) ext_mul(E, run, res[i].Z, run);
    }
    Ext runinv;
    ext_inv(E, run, runinv);
    for (long i = nsc - 1; i >= 0; i--) {
        if (jac_is_inf(K, res[i])) {
            out_inf[i] = 1;
            std::memset(out_xs + i * ds, 0, ds * 8);
            std::memset(out_ys + i * ds, 0, ds * 8);
            continue;
        }
        Ext zi;
        ext_mul(E, runinv, pref[i], zi);       // Z_i^{-1}
        ext_mul(E, runinv, res[i].Z, runinv);  // drop Z_i from the tail
        Ext zi2, zi3, ax, ay;
        ext_sqr(E, zi, zi2);
        ext_mul(E, zi, zi2, zi3);
        ext_mul(E, res[i].X, zi2, ax);
        ext_mul(E, res[i].Y, zi3, ay);
        out_inf[i] = 0;
        ext_store(E, ax, out_xs + i * ds);
        ext_store(E, ay, out_ys + i * ds);
    }
    return 0;
}

// ------------------------------------------------------------------- NTT
// Mixed-radix DFT: out[k] = sum_j x[j] * omega^{jk}, n smooth.
// x, out: n*NL canonical; omega canonical; scale (or NULL) applied to all
// outputs (pass n^{-1} with omega^{-1} for the inverse transform).
struct NTTPlan {
    const FieldCtx *C;
    // omega^i, Montgomery, i < n.  Shared (not copied) so cached hpoly
    // plans hand tables to concurrent provers without ~20 MB memcpys
    // under the plan mutex; eviction stays safe via refcounting.
    std::shared_ptr<const std::vector<Fp>> wtab;
    long n;
};

// scratch: caller-provided, size n for this call (sub-calls get disjoint
// m-sized slices, so parallel subtrees never alias).  threads: budget for
// this subtree.
static void ntt_rec(const NTTPlan &P, const Fp *in, Fp *out, Fp *scratch,
                    long n, long instride, long wstep, int threads) {
    const FieldCtx &C = *P.C;
    if (n == 1) {
        out[0] = in[0];
        return;
    }
    // smallest factor
    long f = 2;
    while (n % f) f++;
    long m = n / f;
    if (threads > 1 && f > 1 && m >= 1024) {
        std::vector<std::thread> ts;
        int sub = std::max(1, (int)(threads / f));
        for (long j2 = 0; j2 < f; j2++) {
            ts.emplace_back([&, j2]() {
                ntt_rec(P, in + j2 * instride, out + j2 * m,
                        scratch + j2 * m, m, instride * f, wstep * f, sub);
            });
        }
        for (auto &t : ts) t.join();
    } else {
        for (long j2 = 0; j2 < f; j2++) {
            ntt_rec(P, in + j2 * instride, out + j2 * m, scratch + j2 * m,
                    m, instride * f, wstep * f, 1);
        }
    }
    // combine: X[k] = sum_j2 w^{wstep*j2*k} Y_j2[k mod m]
    const long N = P.n;
    auto combine = [&](long k0, long k1) {
        for (long k = k0; k < k1; k++) {
            Fp acc = out[k % m]; // j2 = 0 term (weight w^0)
            const std::vector<Fp> &wtab = *P.wtab;
            for (long j2 = 1; j2 < f; j2++) {
                long e = ((wstep * j2 % N) * (k % N)) % N;
                Fp t;
                fp_mont_mul(C, wtab[e], out[j2 * m + (k % m)], t);
                fp_add(C, acc, t, acc);
            }
            scratch[k] = acc;
        }
    };
    if (threads > 1 && n >= 4096) {
        std::vector<std::thread> ts;
        long chunk = (n + threads - 1) / threads;
        for (int t = 0; t < threads; t++) {
            long k0 = t * chunk, k1 = std::min(n, k0 + chunk);
            if (k0 < k1) ts.emplace_back(combine, k0, k1);
        }
        for (auto &t : ts) t.join();
    } else {
        combine(0, n);
    }
    std::memcpy(out, scratch, n * sizeof(Fp));
}

extern "C" int pcd_ntt(long field_h, long n, const u64 *omega, const u64 *x,
                       u64 *out, const u64 *scale_or_null) {
    if (field_h < 0 || field_h >= (long)g_fields.size()) return -1;
    const FieldCtx &C = *g_fields[field_h];
    NTTPlan P;
    P.C = &C;
    P.n = n;
    Fp w;
    std::memcpy(w.v, omega, NL * 8);
    fp_to_mont(C, w, w);
    auto wtab = std::make_shared<std::vector<Fp>>(n);
    (*wtab)[0] = C.one_mont;
    for (long i = 1; i < n; i++)
        fp_mont_mul(C, (*wtab)[i - 1], w, (*wtab)[i]);
    P.wtab = wtab;
    std::vector<Fp> scratch(n);
    std::vector<Fp> xin(n), xout(n);
    for (long i = 0; i < n; i++) {
        Fp t;
        std::memcpy(t.v, x + i * NL, NL * 8);
        fp_to_mont(C, t, xin[i]);
    }
    ntt_rec(P, xin.data(), xout.data(), scratch.data(), n, 1, 1,
            hw_threads());
    Fp sc;
    bool do_scale = scale_or_null != nullptr;
    if (do_scale) {
        std::memcpy(sc.v, scale_or_null, NL * 8);
        fp_to_mont(C, sc, sc);
    }
    for (long i = 0; i < n; i++) {
        Fp t = xout[i];
        if (do_scale) fp_mont_mul(C, t, sc, t);
        fp_from_mont(C, t, t);
        std::memcpy(out + i * NL, t.v, NL * 8);
    }
    return 0;
}

// geometric scale: out[i] = x[i] * g^i (canonical in/out)
extern "C" int pcd_geom_scale(long field_h, long n, const u64 *g,
                              const u64 *x, u64 *out) {
    if (field_h < 0 || field_h >= (long)g_fields.size()) return -1;
    const FieldCtx &C = *g_fields[field_h];
    Fp gm, cur;
    std::memcpy(gm.v, g, NL * 8);
    fp_to_mont(C, gm, gm);
    cur = C.one_mont;
    for (long i = 0; i < n; i++) {
        Fp t;
        std::memcpy(t.v, x + i * NL, NL * 8);
        fp_to_mont(C, t, t);
        fp_mont_mul(C, t, cur, t);
        fp_from_mont(C, t, t);
        std::memcpy(out + i * NL, t.v, NL * 8);
        fp_mont_mul(C, cur, gm, cur);
    }
    return 0;
}

// elementwise ops on canonical vectors: out = (a op b) mod p
// op: 0 add, 1 sub, 2 mul
// ------------------------------------------------------ witness programs
// Native replay of the straight-line witness tape (pcd_tpu/r1cs/program.py
// — the TPU-first answer to the reference re-running circuit synthesis
// per prove, src/ec_cycle_pcd/mod.rs:171,179).  Ops are fixed 5-slot
// int64 records; linear combinations live in a shared flattened table
// with coefficients pre-converted to Montgomery at registration.  Hint
// ops (Marlin's nonnative gadget escape hatch) are NOT supported here —
// the Python tier keeps those programs.
//
// opcode records (code, tgt, a, b, c):
//   0 MUL_VV  z[tgt] = z[a] * z[b]
//   1 MUL_VG  z[tgt] = z[a] * lc(b)
//   2 MUL_GG  z[tgt] = lc(a) * lc(b)
//   3 INV_V   z[tgt] = z[a]^-1          (0 stays 0 — caller's contract)
//   4 INV_G   z[tgt] = lc(a)^-1
//   5 BITS_V  z[tgt+j] = bit (b+j) of z[c],  j < a
//   6 BITS_G  z[tgt+j] = bit (b+j) of lc(c), j < a
//   7 ISZERO  z[tgt] = lc(a) == 0
//   8 INV0    z[tgt] = lc(a)^-1 or 0
//  10 LC      z[tgt] = lc(a)
struct WProg {
    const FieldCtx *C;
    long n_inst, n_wit;
    std::vector<long> ops;      // 5 per op
    std::vector<long> lc_off;   // nlc + 1
    std::vector<long> lc_idx;   // term z-indices
    std::vector<Fp> lc_coeff;   // Montgomery
    std::vector<Fp> lc_const;   // Montgomery, per lc
};
static std::vector<WProg *> g_wprogs;

extern "C" long pcd_wprog_new(long field_h, long n_inst, long n_wit,
                              long nops, const long *ops, long nlc,
                              const long *lc_off, const long *lc_idx,
                              const u64 *lc_coeff, const u64 *lc_const) {
    if (field_h < 0 || field_h >= (long)g_fields.size()) return -1;
    std::lock_guard<std::mutex> g(g_lock);
    const FieldCtx &C = *g_fields[field_h];
    WProg *W = new WProg();
    W->C = &C;
    W->n_inst = n_inst;
    W->n_wit = n_wit;
    W->ops.assign(ops, ops + nops * 5);
    W->lc_off.assign(lc_off, lc_off + nlc + 1);
    const long nterms = lc_off[nlc];
    W->lc_idx.assign(lc_idx, lc_idx + nterms);
    W->lc_coeff.resize(nterms);
    for (long i = 0; i < nterms; i++) {
        Fp t;
        std::memcpy(t.v, lc_coeff + i * NL, NL * 8);
        fp_to_mont(C, t, W->lc_coeff[i]);
    }
    W->lc_const.resize(nlc);
    for (long i = 0; i < nlc; i++) {
        Fp t;
        std::memcpy(t.v, lc_const + i * NL, NL * 8);
        fp_to_mont(C, t, W->lc_const[i]);
    }
    g_wprogs.push_back(W);
    return (long)g_wprogs.size() - 1;
}

extern "C" int pcd_wprog_run(long prog_h, long n_ext, const long *ext_slots,
                             const u64 *ext_vals, u64 *out_z) {
    if (prog_h < 0 || prog_h >= (long)g_wprogs.size()) return -1;
    const WProg &W = *g_wprogs[prog_h];
    const FieldCtx &C = *W.C;
    const long nz = W.n_inst + W.n_wit;
    std::vector<Fp> z(nz);
    std::memset(z.data(), 0, nz * sizeof(Fp));
    z[0] = C.one_mont;
    for (long i = 0; i < n_ext; i++) {
        Fp t;
        std::memcpy(t.v, ext_vals + i * NL, NL * 8);
        fp_to_mont(C, t, z[ext_slots[i]]);
    }
    auto lc_eval = [&](long id, Fp &out) {
        Fp acc = W.lc_const[id];
        for (long j = W.lc_off[id]; j < W.lc_off[id + 1]; j++) {
            Fp t;
            fp_mont_mul(C, W.lc_coeff[j], z[W.lc_idx[j]], t);
            fp_add(C, acc, t, acc);
        }
        out = acc;
    };
    const long nops = (long)W.ops.size() / 5;
    for (long k = 0; k < nops; k++) {
        const long *e = W.ops.data() + k * 5;
        const long code = e[0], tgt = e[1];
        Fp a, b;
        switch (code) {
        case 0:
            fp_mont_mul(C, z[e[2]], z[e[3]], z[tgt]);
            break;
        case 1:
            lc_eval(e[3], b);
            fp_mont_mul(C, z[e[2]], b, z[tgt]);
            break;
        case 2:
            lc_eval(e[2], a);
            lc_eval(e[3], b);
            fp_mont_mul(C, a, b, z[tgt]);
            break;
        case 3:
            fp_inv(C, z[e[2]], z[tgt]);
            break;
        case 4:
            lc_eval(e[2], a);
            fp_inv(C, a, z[tgt]);
            break;
        case 5:
        case 6: {
            if (code == 5) a = z[e[4]];
            else lc_eval(e[4], a);
            Fp canon;
            fp_from_mont(C, a, canon);
            const long n = e[2], start = e[3];
            for (long j = 0; j < n; j++) {
                const long bit = start + j;
                const int limb = (int)(bit / 64), off = (int)(bit % 64);
                const u64 v = (limb < NL) ? ((canon.v[limb] >> off) & 1) : 0;
                if (v) z[tgt + j] = C.one_mont;
                else std::memset(z[tgt + j].v, 0, NL * 8);
            }
            break;
        }
        case 7:
            lc_eval(e[2], a);
            if (fp_is_zero(a)) z[tgt] = C.one_mont;
            else std::memset(z[tgt].v, 0, NL * 8);
            break;
        case 8:
            lc_eval(e[2], a);
            if (fp_is_zero(a)) std::memset(z[tgt].v, 0, NL * 8);
            else fp_inv(C, a, z[tgt]);
            break;
        case 10:
            lc_eval(e[2], z[tgt]);
            break;
        default:
            return -2;
        }
    }
    // canonical output
    const int nthreads = hw_threads();
    auto conv = [&](int tid) {
        for (long i = tid; i < nz; i += nthreads) {
            Fp t;
            fp_from_mont(C, z[i], t);
            std::memcpy(out_z + i * NL, t.v, NL * 8);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < nthreads; t++) ts.emplace_back(conv, t);
    conv(0);
    for (auto &t : ts) t.join();
    return 0;
}

// ------------------------------------------------------- sparse matrices
// CSR R1CS matrices for the prover's Az/Bz/Cz evaluations (reference:
// the witness-map step of ark-groth16/gm17 prove; host tier of
// SURVEY.md D7 "witness generation sharded over constraints").  Values
// are stored in Montgomery form once at registration; apply() converts
// z per call and runs rows threaded.
struct SpMat {
    const FieldCtx *C;
    long nrows;
    std::vector<long> rowptr; // nrows + 1
    std::vector<long> col;    // nnz
    std::vector<Fp> val;      // nnz, Montgomery
};
static std::vector<SpMat *> g_spmats;

extern "C" long pcd_spmat_new(long field_h, long nrows, const long *rowptr,
                              const long *cols, const u64 *vals) {
    if (field_h < 0 || field_h >= (long)g_fields.size()) return -1;
    std::lock_guard<std::mutex> g(g_lock);
    const FieldCtx &C = *g_fields[field_h];
    SpMat *M = new SpMat();
    M->C = &C;
    M->nrows = nrows;
    M->rowptr.assign(rowptr, rowptr + nrows + 1);
    const long nnz = rowptr[nrows];
    M->col.assign(cols, cols + nnz);
    M->val.resize(nnz);
    for (long i = 0; i < nnz; i++) {
        Fp t;
        std::memcpy(t.v, vals + i * NL, NL * 8);
        fp_to_mont(C, t, M->val[i]);
    }
    g_spmats.push_back(M);
    return (long)g_spmats.size() - 1;
}

// out[r] = sum_j val[j] * z[col[j]]; z/out canonical little-endian limbs
extern "C" int pcd_spmat_apply(long mat_h, long nvars, const u64 *z,
                               u64 *out) {
    if (mat_h < 0 || mat_h >= (long)g_spmats.size()) return -1;
    const SpMat &M = *g_spmats[mat_h];
    const FieldCtx &C = *M.C;
    const int nthreads = hw_threads();
    std::vector<Fp> zm(nvars);
    {
        auto conv = [&](int tid) {
            for (long i = tid; i < nvars; i += nthreads) {
                Fp t;
                std::memcpy(t.v, z + i * NL, NL * 8);
                fp_to_mont(C, t, zm[i]);
            }
        };
        std::vector<std::thread> ts;
        for (int t = 1; t < nthreads; t++) ts.emplace_back(conv, t);
        conv(0);
        for (auto &t : ts) t.join();
    }
    auto rows = [&](long r0, long r1) {
        for (long r = r0; r < r1; r++) {
            Fp acc = {{0, 0, 0, 0, 0}};
            for (long j = M.rowptr[r]; j < M.rowptr[r + 1]; j++) {
                Fp t;
                fp_mont_mul(C, M.val[j], zm[M.col[j]], t);
                fp_add(C, acc, t, acc);
            }
            fp_from_mont(C, acc, acc);
            std::memcpy(out + r * NL, acc.v, NL * 8);
        }
    };
    if (nthreads > 1 && M.nrows >= 4096) {
        std::vector<std::thread> ts;
        long chunk = (M.nrows + nthreads - 1) / nthreads;
        for (int t = 0; t < nthreads; t++) {
            long r0 = t * chunk, r1 = std::min(M.nrows, r0 + chunk);
            if (r0 < r1) ts.emplace_back(rows, r0, r1);
        }
        for (auto &t : ts) t.join();
    } else {
        rows(0, M.nrows);
    }
    return 0;
}

extern "C" int pcd_vec_op(long field_h, long n, int op, const u64 *a,
                          const u64 *b, u64 *out) {
    if (field_h < 0 || field_h >= (long)g_fields.size()) return -1;
    const FieldCtx &C = *g_fields[field_h];
    auto run = [&](long i0, long i1) {
        for (long i = i0; i < i1; i++) {
            Fp x, y, r;
            std::memcpy(x.v, a + i * NL, NL * 8);
            std::memcpy(y.v, b + i * NL, NL * 8);
            if (op == 0) {
                fp_add(C, x, y, r);
            } else if (op == 1) {
                fp_sub(C, x, y, r);
            } else {
                fp_to_mont(C, x, x);
                fp_to_mont(C, y, y);
                fp_mont_mul(C, x, y, r);
                fp_from_mont(C, r, r);
            }
            std::memcpy(out + i * NL, r.v, NL * 8);
        }
    };
    int HW = hw_threads();
    if (n >= 16384 && HW > 1) {
        std::vector<std::thread> ts;
        long chunk = (n + HW - 1) / HW;
        for (int t = 0; t < HW; t++) {
            long i0 = t * chunk, i1 = std::min(n, i0 + chunk);
            if (i0 < i1) ts.emplace_back(run, i0, i1);
        }
        for (auto &t : ts) t.join();
    } else {
        run(0, n);
    }
    return 0;
}

// acc[i] += s * x[i] mod p over canonical (n, NL) limb arrays — the
// poly linear-combination primitive of the KZG batch opens (a canonical
// operand against a Montgomery scalar multiplies straight through:
// mont_mul(x, s*R) = x*s).
extern "C" int pcd_vec_axpy(long field_h, long n, const u64 *s,
                            const u64 *x, u64 *acc) {
    if (field_h < 0 || field_h >= (long)g_fields.size()) return -1;
    const FieldCtx &C = *g_fields[field_h];
    Fp sm;
    std::memcpy(sm.v, s, NL * 8);
    fp_to_mont(C, sm, sm);
    auto run = [&](long i0, long i1) {
        for (long i = i0; i < i1; i++) {
            Fp xv, av, t;
            std::memcpy(xv.v, x + i * NL, NL * 8);
            std::memcpy(av.v, acc + i * NL, NL * 8);
            fp_mont_mul(C, xv, sm, t);
            fp_add(C, av, t, av);
            std::memcpy(acc + i * NL, av.v, NL * 8);
        }
    };
    int HW = hw_threads();
    if (n >= 16384 && HW > 1) {
        std::vector<std::thread> ts;
        long chunk = (n + HW - 1) / HW;
        for (int t = 0; t < HW; t++) {
            long i0 = t * chunk, i1 = std::min(n, i0 + chunk);
            if (i0 < i1) ts.emplace_back(run, i0, i1);
        }
        for (auto &t : ts) t.join();
    } else {
        run(0, n);
    }
    return 0;
}

// Synthetic division of sum c_i X^i (n coefficients, canonical limbs)
// by (X - z): writes the n-1 quotient coefficients (may be null) and
// the evaluation c(z) (the remainder).  Sequential Horner — the KZG
// witness-polynomial scan that was a Python-bigint loop.
extern "C" int pcd_poly_div_linear(long field_h, long n, const u64 *coeffs,
                                   const u64 *z, u64 *q, u64 *eval) {
    if (field_h < 0 || field_h >= (long)g_fields.size() || n <= 0)
        return -1;
    const FieldCtx &C = *g_fields[field_h];
    Fp zm;
    std::memcpy(zm.v, z, NL * 8);
    fp_to_mont(C, zm, zm);
    Fp acc, t, c;
    std::memset(acc.v, 0, NL * 8);
    for (long i = n - 1; i >= 1; i--) {
        fp_mont_mul(C, acc, zm, t);
        std::memcpy(c.v, coeffs + i * NL, NL * 8);
        fp_add(C, t, c, acc);
        if (q) std::memcpy(q + (i - 1) * NL, acc.v, NL * 8);
    }
    fp_mont_mul(C, acc, zm, t);
    std::memcpy(c.v, coeffs, NL * 8);
    fp_add(C, t, c, acc);
    std::memcpy(eval, acc.v, NL * 8);
    return 0;
}

// ------------------------------------------------------------ h-poly
// Fused Groth16/GM17 quotient pipeline — ONE call covering what used to
// be 7 pcd_ntt + 3 pcd_geom_scale + Python pointwise stages, each of
// which paid a Python-int <-> limb marshalling round-trip at n=2^18:
//   h = coset_ifft( (coset_fft(ifft(A)) . coset_fft(ifft(B))
//                    - coset_fft(ifft(C))) * zh_inv )
// A/B/C are the domain evaluations (canonical limbs).  Everything stays
// in Montgomery form; the three independent ifft+scale+fft chains run in
// parallel with a per-chain thread budget.  check_rows > 0 additionally
// verifies A[j]*B[j] == C[j] for j < check_rows (the replayed-witness
// satisfiability check) and returns -2 on violation.
static void scaled_geom(const FieldCtx &C, const Fp *in, Fp *out, long n,
                        const Fp &s0, const Fp &g, int threads) {
    auto run = [&](long k0, long k1) {
        Fp e = {{(u64)k0, 0, 0, 0, 0}};
        Fp cur;
        fp_pow(C, g, e, cur);
        fp_mont_mul(C, cur, s0, cur);
        for (long i = k0; i < k1; i++) {
            fp_mont_mul(C, in[i], cur, out[i]);
            fp_mont_mul(C, cur, g, cur);
        }
    };
    if (threads > 1 && n >= 4096) {
        std::vector<std::thread> ts;
        long chunk = (n + threads - 1) / threads;
        for (int t = 0; t < threads; t++) {
            long k0 = t * chunk, k1 = std::min(n, k0 + chunk);
            if (k0 < k1) ts.emplace_back(run, k0, k1);
        }
        for (auto &t : ts) t.join();
    } else {
        run(0, n);
    }
}

extern "C" int pcd_hpoly(long field_h, long n, const u64 *omega,
                         const u64 *coset_g, const u64 *zh_inv,
                         long check_rows, const u64 *a, const u64 *b,
                         const u64 *c, u64 *out) {
    if (field_h < 0 || field_h >= (long)g_fields.size()) return -1;
    const FieldCtx &C = *g_fields[field_h];
    const int HW = hw_threads();

    // plans: forward (omega) and inverse (omega^{-1} = omega^{n-i});
    // twiddle tables cached across calls (4 hpoly calls per IVC step
    // share the same two domains)
    static std::mutex plan_mu;
    struct HPlan {
        long field_h;
        long n;
        Fp omega;
        std::shared_ptr<std::vector<Fp>> fwd, inv;
    };
    static std::vector<std::shared_ptr<HPlan>> plans;
    NTTPlan fwd, inv;
    fwd.C = inv.C = &C;
    fwd.n = inv.n = n;
    {
        Fp w_canon;
        std::memcpy(w_canon.v, omega, NL * 8);
        bool found = false;
        {
            // only the shared_ptr is copied under the lock; eviction is
            // refcount-safe and concurrent provers share one table
            std::lock_guard<std::mutex> lk(plan_mu);
            for (const auto &pl : plans)
                if (pl->field_h == field_h && pl->n == n &&
                    fp_cmp(pl->omega, w_canon) == 0) {
                    fwd.wtab = pl->fwd;
                    inv.wtab = pl->inv;
                    found = true;
                    break;
                }
        }
        if (!found) {
            Fp w;
            fp_to_mont(C, w_canon, w);
            auto ftab = std::make_shared<std::vector<Fp>>(n);
            (*ftab)[0] = C.one_mont;
            for (long i = 1; i < n; i++)
                fp_mont_mul(C, (*ftab)[i - 1], w, (*ftab)[i]);
            auto itab = std::make_shared<std::vector<Fp>>(n);
            (*itab)[0] = C.one_mont;
            for (long i = 1; i < n; i++) (*itab)[i] = (*ftab)[n - i];
            fwd.wtab = ftab;
            inv.wtab = itab;
            auto pl = std::make_shared<HPlan>();
            pl->field_h = field_h;
            pl->n = n;
            pl->omega = w_canon;
            pl->fwd = ftab;
            pl->inv = itab;
            std::lock_guard<std::mutex> lk(plan_mu);
            plans.push_back(pl);
            if (plans.size() > 16) plans.erase(plans.begin());
        }
    }
    Fp n_inv = {{(u64)n, 0, 0, 0, 0}};
    fp_to_mont(C, n_inv, n_inv);
    fp_inv(C, n_inv, n_inv);
    Fp g, g_inv, zhi;
    std::memcpy(g.v, coset_g, NL * 8);
    fp_to_mont(C, g, g);
    fp_inv(C, g, g_inv);
    std::memcpy(zhi.v, zh_inv, NL * 8);
    fp_to_mont(C, zhi, zhi);

    // inputs -> Montgomery.  b == a is the SAP/GM17 squaring case
    // (h = (A^2 - C)/Z_H): the B chain is skipped entirely.
    const bool sq = (b == a);
    std::vector<Fp> V[3];
    const u64 *src[3] = {a, b, c};
    {
        std::vector<std::thread> ts;
        for (int k = 0; k < 3; k++) {
            if (sq && k == 1) continue;
            V[k].resize(n);
            ts.emplace_back([&, k]() {
                for (long i = 0; i < n; i++) {
                    Fp t;
                    std::memcpy(t.v, src[k] + i * NL, NL * 8);
                    fp_to_mont(C, t, V[k][i]);
                }
            });
        }
        for (auto &t : ts) t.join();
    }

    // replayed-witness satisfiability: A[j]*B[j] == C[j], j < check_rows
    if (check_rows > 0) {
        std::vector<std::thread> ts;
        std::mutex mu;
        bool bad = false;
        long chunk = (check_rows + HW - 1) / HW;
        for (int t = 0; t < HW; t++) {
            long k0 = t * chunk, k1 = std::min(check_rows, k0 + chunk);
            if (k0 >= k1) continue;
            ts.emplace_back([&, k0, k1]() {
                const std::vector<Fp> &B = sq ? V[0] : V[1];
                for (long j = k0; j < k1; j++) {
                    Fp ab;
                    fp_mont_mul(C, V[0][j], B[j], ab);
                    Fp d;
                    fp_sub(C, ab, V[2][j], d);
                    if (!fp_is_zero(d)) {
                        std::lock_guard<std::mutex> lk(mu);
                        bad = true;
                        return;
                    }
                }
            });
        }
        for (auto &t : ts) t.join();
        if (bad) return -2;
    }

    // three independent ifft -> (n^{-1} g^i) scale -> fft chains
    {
        std::vector<std::thread> ts;
        int sub = std::max(1, HW / (sq ? 2 : 3));
        for (int k = 0; k < 3; k++) {
            if (sq && k == 1) continue;
            ts.emplace_back([&, k]() {
                std::vector<Fp> tmp(n), scratch(n);
                ntt_rec(inv, V[k].data(), tmp.data(), scratch.data(), n, 1,
                        1, sub);
                scaled_geom(C, tmp.data(), scratch.data(), n, n_inv, g,
                            sub);
                ntt_rec(fwd, scratch.data(), V[k].data(), tmp.data(), n, 1,
                        1, sub);
            });
        }
        for (auto &t : ts) t.join();
    }

    // pointwise (A.B - C) * zh_inv on the coset, into V[0]
    {
        std::vector<std::thread> ts;
        long chunk = (n + HW - 1) / HW;
        for (int t = 0; t < HW; t++) {
            long k0 = t * chunk, k1 = std::min(n, k0 + chunk);
            if (k0 >= k1) continue;
            ts.emplace_back([&, k0, k1]() {
                const std::vector<Fp> &B = sq ? V[0] : V[1];
                for (long i = k0; i < k1; i++) {
                    Fp ab;
                    fp_mont_mul(C, V[0][i], B[i], ab);
                    fp_sub(C, ab, V[2][i], ab);
                    fp_mont_mul(C, ab, zhi, V[0][i]);
                }
            });
        }
        for (auto &t : ts) t.join();
    }

    // coset_ifft: inverse transform then n^{-1} g^{-i} scale, -> canonical
    {
        if (sq) V[1].resize(n);
        std::vector<Fp> &tmp = V[1];
        std::vector<Fp> &scratch = V[2];
        ntt_rec(inv, V[0].data(), tmp.data(), scratch.data(), n, 1, 1, HW);
        scaled_geom(C, tmp.data(), scratch.data(), n, n_inv, g_inv, HW);
        std::vector<std::thread> ts;
        long chunk = (n + HW - 1) / HW;
        for (int t = 0; t < HW; t++) {
            long k0 = t * chunk, k1 = std::min(n, k0 + chunk);
            if (k0 >= k1) continue;
            ts.emplace_back([&, k0, k1]() {
                for (long i = k0; i < k1; i++) {
                    Fp r;
                    fp_from_mont(C, scratch[i], r);
                    std::memcpy(out + i * NL, r.v, NL * 8);
                }
            });
        }
        for (auto &t : ts) t.join();
    }
    return 0;
}

// --------------------------------------------------------- MSM schedule
// Host-side bookkeeping for the TPU stream MSM (pcd_tpu/ops/msm_stream.py):
// signed c-bit digit extraction + a proportional lane allocation, emitted
// as the (nwin, T, L) gather permutation, per-lane loads and per-bucket
// first-lane indices the device pipeline consumes.  Pure integer passes
// (no field math); threaded over windows.
//
// Two-call protocol: pass T = 0 to compute the REQUIRED number of rounds
// (quantized to a multiple of 8, returned as a positive value; output
// buffers may be NULL).  Then call again with that T and the buffers.
// Returns -1 on bad arguments, -2 when the given T is too small.
extern "C" long pcd_msm_schedule(long n, int c, int nwin, long L, long B,
                                 long T, int carry_win, const u64 *scalars,
                                 long nlimbs, const u8 *inf, u32 *perm,
                                 i32 *loads, i32 *bidx) {
    if (n <= 0 || c < 2 || c > 14 || nwin < 2 || L <= 0 || B != (1L << (c - 1)))
        return -1;
    const int base = nwin - 1;
    const u32 mask = (1u << c) - 1;
    const long half = 1L << (c - 1), full = 1L << c;

    // signed digits, (nwin, n): mag in [0, B], sign in bit 31.  The
    // last row is either the carry-out window (carry_win) or the top
    // real window absorbing the carry unsigned (the caller guarantees
    // mag <= B headroom; overflow is reported as -3).
    std::atomic<int> bad{0};
    std::vector<u32> dig((size_t)nwin * n);
    {
        const int HW = hw_threads();
        std::vector<std::thread> ts;
        long chunk = (n + HW - 1) / HW;
        for (int t = 0; t < HW; t++) {
            long i0 = t * chunk, i1 = std::min(n, i0 + chunk);
            if (i0 >= i1) continue;
            ts.emplace_back([&, i0, i1]() {
                for (long i = i0; i < i1; i++) {
                    if (inf && inf[i]) {
                        for (int w = 0; w < nwin; w++)
                            dig[(size_t)w * n + i] = 0;
                        continue;
                    }
                    const u64 *s = scalars + i * nlimbs;
                    long carry = 0;
                    for (int w = 0; w < base; w++) {
                        long bit = (long)w * c;
                        long word = bit >> 6;
                        int sh = (int)(bit & 63);
                        u64 v = word < nlimbs ? (s[word] >> sh) : 0;
                        if (sh + c > 64 && word + 1 < nlimbs)
                            v |= s[word + 1] << (64 - sh);
                        long d = (long)(v & mask) + carry;
                        carry = d >= half ? 1 : 0;
                        d -= carry * full;
                        dig[(size_t)w * n + i] =
                            d < 0 ? ((u32)(-d) | 0x80000000u) : (u32)d;
                    }
                    if (carry_win) {
                        dig[(size_t)base * n + i] = (u32)carry;
                    } else {
                        long bit = (long)base * c;
                        long word = bit >> 6;
                        int sh = (int)(bit & 63);
                        u64 v = word < nlimbs ? (s[word] >> sh) : 0;
                        if (sh + c > 64 && word + 1 < nlimbs)
                            v |= s[word + 1] << (64 - sh);
                        long d = (long)(v & mask) + carry;
                        if (d > B) bad.store(1);
                        dig[(size_t)base * n + i] = (u32)d;
                    }
                }
            });
        }
        for (auto &t : ts) t.join();
    }
    if (bad.load()) return -3;

    // per-window bucket counts -> global required T
    std::vector<std::vector<long>> counts(nwin);
    long Tneed = 1;
    {
        const int HW = hw_threads();
        std::vector<long> tn(nwin, 1);
        std::vector<std::thread> ts;
        std::atomic<int> next{0};
        for (int t = 0; t < HW; t++) {
            ts.emplace_back([&]() {
                int w;
                while ((w = next.fetch_add(1)) < nwin) {
                    auto &cn = counts[w];
                    cn.assign(B + 1, 0);
                    const u32 *dw = dig.data() + (size_t)w * n;
                    long m = 0;
                    for (long i = 0; i < n; i++) {
                        u32 mag = dw[i] & 0x7FFFFFFFu;
                        cn[mag]++;
                        if (mag) m++;
                    }
                    long Tw = std::max(1L, (m + L - 1) / L);
                    for (;;) {
                        long lanes = 0;
                        for (long b = 1; b <= B; b++)
                            lanes += (cn[b] + Tw - 1) / Tw;
                        if (lanes <= L) break;
                        Tw += std::max(1L, Tw / 8);
                    }
                    tn[w] = Tw;
                }
            });
        }
        for (auto &t : ts) t.join();
        for (int w = 0; w < nwin; w++) Tneed = std::max(Tneed, tn[w]);
        Tneed = (Tneed + 3) / 4 * 4;
    }
    if (T == 0) return Tneed;
    if (T < Tneed) return -2;
    if (!perm || !loads || !bidx) return -1;

    // placement with the agreed T (threaded over windows)
    {
        const int HW = hw_threads();
        std::vector<std::thread> ts;
        std::atomic<int> next{0};
        for (int t = 0; t < HW; t++) {
            ts.emplace_back([&]() {
                int w;
                while ((w = next.fetch_add(1)) < nwin) {
                    const auto &cn = counts[w];
                    const u32 *dw = dig.data() + (size_t)w * n;
                    std::vector<long> lanes_b(B + 1, 0), start(B + 1, 0),
                        ctr(B + 1, 0);
                    long s0 = 0;
                    for (long b = 1; b <= B; b++) {
                        lanes_b[b] = (cn[b] + T - 1) / T;
                        start[b] = s0;
                        s0 += lanes_b[b];
                    }
                    u32 *pw = perm + (size_t)w * T * L;
                    std::memset(pw, 0, sizeof(u32) * T * L);
                    for (long i = 0; i < n; i++) {
                        u32 d = dw[i];
                        u32 mag = d & 0x7FFFFFFFu;
                        if (!mag) continue;
                        long j = ctr[mag]++;
                        long lane = start[mag] + j % lanes_b[mag];
                        long rnd = j / lanes_b[mag];
                        pw[rnd * L + lane] =
                            (u32)i | (d & 0x80000000u);
                    }
                    i32 *lw = loads + (size_t)w * L;
                    std::memset(lw, 0, sizeof(i32) * L);
                    for (long b = 1; b <= B; b++)
                        for (long j = 0; j < lanes_b[b]; j++)
                            lw[start[b] + j] =
                                (i32)(cn[b] / lanes_b[b]
                                      + (j < cn[b] % lanes_b[b] ? 1 : 0));
                    // global first-lane per bucket; sentinel nwin*L
                    i32 *bw = bidx + (size_t)w * B;
                    long run = (long)nwin * L;
                    for (long b = B; b >= 1; b--) {
                        if (cn[b] > 0) run = (long)w * L + start[b];
                        bw[b - 1] = (i32)run;
                    }
                }
            });
        }
        for (auto &t : ts) t.join();
    }
    return Tneed;
}
