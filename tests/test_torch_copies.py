"""The port's copies of the JAX package's framework-free modules stay the
same text as their modules.  Each copy of `pcd_tpu/<path>` lives at
`pcd_tpu_torch/<path>` and differs from it only by its mirror paragraph
("The port's copy of `pcd_tpu/<path>`; ...") and by the hunks listed in
EDITED: the per-process temporaries of `pcd/ec_cycle.py` (its placeholder
cache) and `native/__init__.py` (its build), the port's profiling of both
(a step's request, the spans of the stream-MSM schedule), the
`EncodedPoints` table made from the keygen kernel's words and padded in
front with points at infinity (`native/__init__.py`), the docstrings of
`fields/constants.py` and `fields/prime.py`, which name the reference by
its name and not by a path, and the absolute imports of
`parallel/farm.py`'s workers, which rebuild the pk from the port's
configs, and `parallel/pipeline.py`'s help worker, which marks a failing
item done so that a help prove that raises makes prove_chain raise (the
module waits for ever there).  An EDITED hunk is the copy's lines and a
digest of the module lines they stand for, so a change on either side
fails the test.  Reads files only; imports nothing of either package.
"""

import difflib
import hashlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIRROR = "The port's copy of `pcd_tpu/"
PACKAGES = ("crh", "curves", "fields", "gadgets", "msm", "ops", "pairing",
            "parallel", "pcd", "poly", "r1cs", "snark", "snark/gm17",
            "snark/groth16", "snark/marlin", "utils")
COPIES = (
    "crh/api.py", "crh/bowe_hopwood.py", "crh/pedersen.py",
    "curves/models.py",
    "curves/short_weierstrass.py", "curves/twisted_edwards.py",
    "fields/constants.py", "fields/prime.py", "fields/tower.py",
    "gadgets/fields_ext.py", "gadgets/fp.py", "gadgets/inputs.py",
    "gadgets/nonnative.py", "gadgets/pairing.py", "gadgets/sw.py",
    "gadgets/te.py", "msm/host.py", "native/__init__.py",
    "native/pcd_native.cpp", "pairing/ate.py", "pcd/api.py",
    "parallel/farm.py", "parallel/pipeline.py", "pcd/ec_cycle.py",
    "poly/domain.py", "r1cs/program.py",
    "r1cs/system.py", "snark/api.py", "snark/gm17/gadget.py",
    "snark/groth16/gadget.py", "snark/marlin/gadget.py",
    "snark/marlin/poseidon.py", "snark/plan.py", "utils/rng.py",
) + tuple(f"{p}/__init__.py" for p in PACKAGES)
EDITED = {
    "pcd/ec_cycle.py": [
        (("from ..utils.profiling import request, span",),
         "1dc4ca416d18c3d4"),
        (("        # the package name leads the key: the JAX package writes "
          "the same",
          "        # (scheme, curve, size) placeholders into this directory, "
          "and two",
          "        # packages' test workers must never race on one file",
          '        key = ("pcd_tpu_torch", type(snark).__name__, '
          'snark.cfg.name,',
          "               public_input_size)"), "ac6f96207468bdc3"),
        (('                tmp = f"{fname}.{os.getpid()}.tmp"   # one per '
          'process',), "e3b836d380b0068f"),
        (("    @request()",), "e3b0c44298fc1c14")],
    "native/__init__.py": [
        (("from ..utils.profiling import span", ""), "e3b0c44298fc1c14"),
        (("    # one temporary per process: test workers that start "
          "together each",
          "    # build and atomically rename their own complete library",
          '    tmp = f"{so}.{os.getpid()}.tmp"'), "e3b0c44298fc1c14"),
        (('             "-o", tmp],',), "8d3c5a5215aa39f2"),
        (("        os.replace(tmp, so)",), "d5849a0bbd373184"),
        (("",
          "    @classmethod",
          '    def from_affine_words(cls, curve, words) -> "EncodedPoints":',
          '        """The table of affine canonical 32-bit words as the '
          "keygen kernel",
          "        returns them (ops/fixed_base.py `mul_digits`, a "
          "tensor or array):",
          "        (n, 2, d, 10), x then y, the point at infinity zero "
          "with bit 31",
          '        of x\'s top word set.  Builds no host point objects."""',
          '        if hasattr(words, "cpu"):',
          "            words = words.cpu().numpy()",
          "        w = np.array(words).view(np.uint32)              # a copy",
          "        n, two, d, nw = w.shape",
          "        out = object.__new__(cls)",
          "        out.curve = curve",
          "        out.handle, out.deg, _ = curve_handle(curve)",
          "        if (two, d, nw) != (2, out.deg, 2 * NL):",
          '            raise ValueError(f"affine words of {curve.name}: '
          '(n, 2, "',
          '                             f"{out.deg}, {2 * NL}), not '
          '{w.shape}")',
          "        out.inf = (w[:, 0, 0, -1] >> 31).astype(np.uint8)",
          "        w[:, 0, 0, -1] &= np.uint32(0x7FFFFFFF)",
          '        xy = w.reshape(n, -1).view("<u8")',
          "        out.xs = np.ascontiguousarray(xy[:, : NL * d])",
          "        out.ys = np.ascontiguousarray(xy[:, NL * d:])",
          "        out.n = n",
          "        return out",
          "",
          '    def pad_front(self, k: int) -> "EncodedPoints":',
          '        """k points at infinity, then this table\'s rows (a '
          'copy)."""',
          "        out = object.__new__(EncodedPoints)",
          "        out.curve, out.handle, out.deg = self.curve, "
          "self.handle, self.deg",
          "        pad = np.zeros((k, self.xs.shape[1]), dtype=self.xs.dtype)",
          "        out.xs = np.concatenate([pad, self.xs])",
          "        out.ys = np.concatenate([pad, self.ys])",
          "        out.inf = np.concatenate([np.ones(k, np.uint8), self.inf])",
          "        out.n = self.n + k",
          "        return out"),
         "e3b0c44298fc1c14"),
        (('    with span("sched_fit"):',
          "        T = lib.pcd_msm_schedule(n, c, nwin, L, B, 0, cw, "
          "_u64p(limbs), nl,",
          "                                 inf_p, nullp, nulli, nulli)"),
         "a14cd089624ba41d"),
        (('    with span("sched_alloc"):',
          "        perm = np.zeros((nwin, T * L), dtype=np.uint32)",
          "        loads = np.zeros((nwin, L), dtype=np.int32)",
          "        bidx = np.zeros((nwin, B), dtype=np.int32)",
          '    with span("sched_place"):',
          "        rc = lib.pcd_msm_schedule(",
          "            n, c, nwin, L, B, T, cw, _u64p(limbs), nl, inf_p,",
          "            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),",
          "            loads.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),",
          "            bidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))"),
         "213c72eeef10fc6f")],
    "fields/constants.py": [
        (("`ark-ed-on-mnt4-298` (Cargo.toml:31-34) whose sources are NOT "
          "vendored with",
          "the reference.  The base constants below (moduli, curve "
          "coefficients, G1"), "04353036cfc88800")],
    "parallel/farm.py": [
        (("    import pcd_tpu_torch.configs as configs",
          "    from pcd_tpu_torch.utils.rng import ChaChaRng"),
         "20a5e76cb62f79a5"),
        (("    from pcd_tpu_torch.utils.rng import ChaChaRng",
          "    from pcd_tpu_torch.utils.serialize import pcd_proof_from_bytes, \\"),
         "f6e66e3a57241cbb")],
    "parallel/pipeline.py": [
        (("            # every item taken is marked done, the failing one "
          "too, so the",
          "            # main thread's join returns and raises the error",
          "            while True:",
          "                item = help_in.get()",
          "                try:"), "6579bef4bc06fa66"),
        (("                except Exception as e:",
          "                    errors.append(e)",
          "                    return",
          "                finally:"), "e3b0c44298fc1c14"),
        ((), "3777970a55c88076")],
    "fields/prime.py": [
        (("pinned at the reference's Cargo.toml:17) implements "
          "Montgomery-form scalar",), "c02cdf068eca468c")],
}


def _strip_mirror(lines):
    """The lines without the mirror paragraph and the blank (or "//")
    line before it."""
    out, i = [], 0
    while i < len(lines):
        if MIRROR in lines[i]:
            if out and out[-1].strip() in ("", "//"):
                out.pop()
            while i < len(lines) and lines[i].strip() not in ("", "//",
                                                               '"""'):
                i += 1
            continue
        out.append(lines[i])
        i += 1
    return out


def _join_quotes(lines):
    """A docstring's closing quotes on a line of their own joined to the
    line before (the copy may have moved them below its paragraph)."""
    out = []
    for ln in lines:
        if ln == '"""' and out and out[-1].strip() and '"""' not in out[-1]:
            out[-1] += ln
        else:
            out.append(ln)
    return out


def _read(*parts):
    with open(os.path.join(ROOT, *parts), encoding="utf-8") as fh:
        return fh.read().split("\n")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_module(rel):
    port = _read("pcd_tpu_torch", rel)
    ref = _read("pcd_tpu", rel)
    if rel.endswith("__init__.py") and not any(ln.strip() for ln in ref):
        assert not any(ln.strip() for ln in port)
        return
    assert any(f"{MIRROR}{rel}`" in ln for ln in port), "no mirror line"
    port, ref = _join_quotes(_strip_mirror(port)), _join_quotes(ref)
    hunks = [(tuple(port[j1:j2]),
              hashlib.sha256("\n".join(ref[i1:i2]).encode()).hexdigest()[:16])
             for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
                 None, ref, port, autojunk=False).get_opcodes()
             if tag != "equal"]
    assert hunks == EDITED.get(rel, [])
