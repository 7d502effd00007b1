"""The plain reference's Groth16 commitment phase: the proof (A, B, C) a
prover commits to, from the scalars alone, for a key whose query tables
are t_i G for integers t_i the caller made (the benchmark's keygen draws
them), and whose alpha, beta and delta it drew.  Plain Python on the
frozen curves beside it; it imports nothing of the program.

With r the scalar field's order, each query's MSM is (sum s_i t_i mod r)
times the generator, so

  A  = (alpha + sum_i z_i t^a_i + r' delta) G1
  B  = (beta + sum_i z_i t^b2_i + s' delta) G2
  B1 = (beta + sum_i z_i t^b1_i + s' delta) G1
  C  = (sum_{i >= n_inst} z_i t^l_{i - n_inst} + sum_j h_j t^h_j) G1
       + s' A + r' B1 - r' s' delta G1

(r', s' the prover's randomness): one sum of products a query and one
scalar product a point, on either curve of the cycle.
"""

from __future__ import annotations

from .checks import encode


def _dot(s, t, r: int) -> int:
    return sum(map(int.__mul__, s, t)) % r


def groth16_proof(cfg, t: dict, z, h, n_inst: int, trapdoor, rs) -> dict:
    """{"a", "b", "c"} as plain encodings.  cfg: the reference's curve
    configuration; t: {query: [t_i]} for a_query, b_g1_query, b_g2_query,
    l_query (the witness columns, len(z) - n_inst rows) and h_query; z, h:
    the scalars as ints; trapdoor: (alpha, beta, delta); rs: (r', s')."""
    r = cfg.Fr.MODULUS
    alpha, beta, delta = trapdoor
    rp, sp = rs
    ka = (alpha + _dot(z, t["a_query"], r) + rp * delta) % r
    kb2 = (beta + _dot(z, t["b_g2_query"], r) + sp * delta) % r
    kb1 = (beta + _dot(z, t["b_g1_query"], r) + sp * delta) % r
    kc = (_dot(z[n_inst:], t["l_query"], r) + _dot(h, t["h_query"], r)
          + sp * ka + rp * kb1 - rp * sp * delta) % r
    return {"a": encode(cfg.g1_gen * ka), "b": encode(cfg.g2_gen * kb2),
            "c": encode(cfg.g1_gen * kc)}
