"""The DCN kernels on the card: K1 (the flagship's DCNv2,
``csrc/deform_conv.cu``) or the bounded K2 / K3 (``csrc/deform_window.cu``)
of this tree beside those of another source, and where their time goes.

    python -m yolo_ad_refine_tpu_torch.engine.profile_dcn [--kernel k1|separable|window]
        [--baseline OLD.cu] [--split] [--tree-split] [--out FILE]

``--kernel k1`` (the default): times K1 fwd in fp32 at batch 32 and in bf16
at batch 16, and K1 bwd in both at batch 16, each over the flagship's three
AYHead levels (80², 40², 20², C = Cout = 64, offsets N(0, 4²), radius
None), as ``chip_smoke.py`` times them: CUDA-event means after warm-up,
through the wrappers of ``ops/deform.py`` for this tree. ``--baseline``
names an earlier ``deform_conv.cu`` with the entry points ``dcn_forward`` /
``dcn_backward``, and either the weight laid out (9, C, Cout) (before the
tensor-core K1) or this tree's C interface (it exports ``dcn_smem_bytes``),
which runs through this tree's wrappers; it is built with the same flags
and timed in turns with this tree's (baseline, tree, tree, baseline).
``--split`` also builds three cut copies of the baseline's backward
(``SPLITS``) and times them: the two C x Cout products alone, the corner
work with the dx scatter and the corner work without it; ``--tree-split``
does the same for this tree's kernels (``TREE_SPLITS``: the forward's
products alone and gather alone, and the backward's three cuts), timed
through this tree's wrappers.

``--kernel separable`` (K2) or ``window`` (K3): the same at radius 3 with
offsets N(0, 4²) (most beyond the radius, every other tap's y-offset
integral): the forward in fp32 at batch 32 and bf16 at batch 16, the
backward in both at batch 16, both at C = Cout = 384, batch 16 (the
flagship's scale-x width), and both at batch 8 at radius 13 (the widened
reload) and 31 (past the window, the global modes), offsets scaled by
radius / 3 (``WINDOW_CASES``). ``--baseline`` names an earlier
``deform_window.cu`` with this tree's forward interface (it exports
``dcn_window_fwd_smem_bytes``): one that also has this tree's backward
interface (it exports ``dcn_window_bwd_shape``) runs through this tree's
wrappers, one with the earlier fp32-core backward (a chunk its
``dcn_window_bwd_smem_bytes(radius, C, Cout, cc, dtype)`` sizes) runs its
backward as its own wrapper called it. The baseline's outputs are held
against the tree's (the forward's max |difference|, the backward's), and
each backward of the C = Cout = 64 cases against the plain version (max
|kernel - plain| / max |plain| per gradient, on the 80² level); a case
the baseline does not launch is recorded with its error. ``--tree-split``
times cut copies of this tree's kernels (``WINDOW_TREE_SPLITS``: the
forward's products alone, its window staging and sampling alone and
64-channel blocks where the plan takes 128; the backward's products alone,
its sampling alone, its dx lists' sums alone, what all of these keep, and
the whole backward with dx stored instead of added by atomics).

Every build's ``-Xptxas -v`` lines (registers, shared memory, spills) are
printed. The copies and their libraries go to ``csrc/build/profile/``.
Nothing here is checked: ``chip_smoke.py`` is the pass/fail run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import time
from pathlib import Path

import torch

from yolo_ad_refine_tpu_torch.ops import deform
from yolo_ad_refine_tpu_torch.utils import kernels

LEVELS = (80, 40, 20)
C = 64
KK = 9
GRADS = ("dx", "doffset", "dmask", "dweight")

# cut copies of the earlier backward (fp32 FMAs, before the tensor-core
# design): (text in the source, its replacement)
SPLITS = {
    # the per-pixel corner loop never runs: g . W_t^T and the dW_t update remain
    "products": [("for (int pi = warp; pi < TP; pi += NT / 32) {",
                  "for (int pi = warp; pi < 0; pi += NT / 32) {")],
    # one term for g . W_t^T and none for dW_t: the corner work and the scatter remain
    "corners_scatter": [("for (int o = 0; o < Cout; ++o) acc = fmaf(gr[o], wr[o], acc);",
                         "acc = gr[0] * wr[0];"),
                        ("for (int pp = 0; pp < TP; ++pp) acc = fmaf(s_ms[pp * C + c], "
                         "s_g[pp * Cout + o], acc);", "")],
}
SPLITS["corners"] = SPLITS["corners_scatter"] + [
    ("atomicAdd(dx + q, (double)(wk[k] * mg));", ";")]

# cut copies of this tree's kernels (csrc/deform_conv.cu)
TREE_SPLITS = {
    # forward: no corner reads (zero-filled copies), the products remain
    "fwd_products": [("if (q >= 0 && c < C) {", "if (false) {")],
    # forward: no mma, the gather into shared memory remains
    "fwd_gather": [("if (j < ntw) {", "if (j < 0) {")],
    # backward: the corner loop never runs, gs and the dW_t update remain
    "bwd_products": [("for (int pb = warp * ppw; pb < TP;", "for (int pb = warp * ppw; pb < 0;")],
    # backward: no mma, the corner work and the scatter remain
    "bwd_corners_scatter": [("if (j < gntw) {", "if (j < 0) {"),
                            ("if (cm < L.cpn) {", "if (false) {")],
}
TREE_SPLITS["bwd_corners"] = TREE_SPLITS["bwd_corners_scatter"] + [
    ("if (wk[k] != 0.f) atomicAdd(dx + (size_t)idx[k] * C + c0 + c, (double)(wk[k] * mg));",
     ";")]

# cut copies of this tree's K2 / K3 kernels (csrc/deform_window.cu, the
# lines marked "split:")
WINDOW_TREE_SPLITS = {
    # no samples are formed (the tiles stay zero): the window copies, the
    # weight tiles and the products remain
    "fwd_products": [("sample(0, 0);  // split: sampling", ";"),
                     ("sample(st + 1, (st + 1) & 1);  // split: sampling", ";")],
    # no mma: the window copies, the weight tiles and the sampling remain
    "fwd_sampling": [("if (2 * jp + h < ntw) {  // split: products", "if (false) {"),
                     ("if (2 * jp + h < ntw)  // split: products", "if (false)")],
    # 64-channel blocks where the plan takes 128 (C = Cout = 384)
    "fwd_nb64": [("if (nb == 64)  // split: nb", "if (true)")],
    # backward: no sampling and no dx lists summed: the staging, the lists'
    # build, the two products, doffset / dmask of zero sums and the barriers
    # remain
    "bwd_products": [("for (int h = 0; h < 2; ++h) {  // split: sampling",
                      "for (int h = 0; h < 0; ++h) {"),
                     ("for (int e = s_bstart[q], e1 = s_bstart[q + 1]; e < e1; ++e) {  "
                      "// split: gather", "for (int e = 0; e < 0; ++e) {")],
    # backward: no mma (gs stays zero): the staging, the sampling, the
    # corner dots, the lists' build and their sums (of zeros, so nothing is
    # added into dx) remain
    "bwd_sampling": [("for (int k = 0; k < kgs; k += 8) {  // split: products",
                      "for (int k = 0; k < 0; k += 8) {"),
                     ("if (dlive) {  // split: products", "if (false) {")],
}
# backward: the dx lists' sums and their additions into dx alone (no
# products, no sampling), with the staging, the lists' build and the barriers
WINDOW_TREE_SPLITS["bwd_gather"] = [
    WINDOW_TREE_SPLITS["bwd_products"][0], *WINDOW_TREE_SPLITS["bwd_sampling"],
    ("if (acc[j] == 0.0) continue;  // split: gather zeros", ";")]
# backward: what every cut keeps (the staging, the geometry and the lists'
# build, the weight and g loads, the barriers, doffset / dmask of zero sums)
WINDOW_TREE_SPLITS["bwd_frame"] = (WINDOW_TREE_SPLITS["bwd_products"]
                                   + WINDOW_TREE_SPLITS["bwd_sampling"])
# backward: the whole kernel with dx stored instead of added atomically
# (wrong sums; the atomics' cost)
WINDOW_TREE_SPLITS["bwd_store"] = [
    ("if (c0 + c + j < C) atomicAdd(d + j, acc[j]);  // split: store",
     "if (c0 + c + j < C) d[j] = acc[j];")]


def build(sources: dict[str, Path], flags_of: str = "deform_conv") -> dict[str, ctypes.CDLL]:
    """{name: library} for {name: source}, one nvcc each with the flags of
    ``flags_of``, all started together; prints each build's -Xptxas -v
    lines."""
    out_dir = kernels.BUILD / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = out_dir / f"lib{name}.so"
        cmd = [kernels.nvcc_path(), *kernels._flags(flags_of), "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
        libs[name].yat_cuda_error_string.restype = ctypes.c_char_p
        libs[name].yat_cuda_error_string.argtypes = [ctypes.c_int]
    return libs


def cut_copy(src: Path, split: str, edits, out_dir: Path | None = None) -> Path:
    """``src`` with each (text, replacement) of ``edits`` made, every time
    the text occurs (it must occur), written to ``out_dir`` (by default
    ``csrc/build/profile/``)."""
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"split {split}: {old!r} is not in {src}")
        text = text.replace(old, new)
    out = (out_dir or kernels.BUILD / "profile") / f"{src.stem}_{split}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def inputs(b: int, s: int, dtype, gen, c: int = C):
    x = torch.randn(b, s, s, c, generator=gen).to("cuda", dtype)
    off = (torch.randn(b, s, s, 18, generator=gen) * 4.0).cuda()
    mask = torch.rand(b, s, s, 9, generator=gen).cuda()
    w = (torch.randn(3, 3, c, c, generator=gen) / math.sqrt(9 * c)).to("cuda", dtype)
    g = torch.randn(b, s, s, c, generator=gen).to("cuda", dtype)
    return x, off, mask, w, g


class Baseline:
    """An earlier deform_conv.cu called as its own wrapper called it: weight
    (9, C, Cout), dx and dweight summed in fp64 and rounded once."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.dcn_forward.restype = lib.dcn_backward.restype = ctypes.c_int
        lib.dcn_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.dcn_backward.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    @staticmethod
    def _dtype(t):
        return 0 if t.dtype == torch.float32 else 1

    def forward(self, x, off, mask, w):
        b, h, wd, c = x.shape
        cout = w.shape[-1]
        wk = w.reshape(KK, c, cout).contiguous()
        out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
        st = self.lib.dcn_forward(x.data_ptr(), off.data_ptr(), mask.data_ptr(), wk.data_ptr(),
                                  out.data_ptr(), b, h, wd, c, cout, -1.0, self._dtype(x),
                                  torch.cuda.current_stream().cuda_stream)
        if st:
            raise RuntimeError(f"baseline dcn_forward: CUDA error {st}")
        return out

    def backward(self, x, off, mask, w, g):
        b, h, wd, c = x.shape
        cout = w.shape[-1]
        wk = w.reshape(KK, c, cout).contiguous()
        dx = torch.zeros((b, h, wd, c), dtype=torch.float64, device=x.device)
        doff = torch.empty((b, h, wd, 18), dtype=torch.float32, device=x.device)
        dmask = torch.empty((b, h, wd, 9), dtype=torch.float32, device=x.device)
        dw = torch.zeros((KK, c, cout), dtype=torch.float64, device=x.device)
        st = self.lib.dcn_backward(x.data_ptr(), off.data_ptr(), mask.data_ptr(), wk.data_ptr(),
                                   g.data_ptr(), dx.data_ptr(), doff.data_ptr(), dmask.data_ptr(),
                                   dw.data_ptr(), b, h, wd, c, cout, -1.0, self._dtype(x),
                                   torch.cuda.current_stream().cuda_stream)
        if st:
            raise RuntimeError(f"baseline dcn_backward: CUDA error {st}")
        return dx.to(x.dtype), doff, dmask, dw.to(w.dtype)


class Tree:
    """This tree's K1 through the wrappers of ops/deform.py; with ``lib``, a
    cut copy of it put in the wrappers' place for each call."""

    def __init__(self, lib: ctypes.CDLL | None = None):
        self.lib = lib

    def _call(self, fn, *args):
        saved = kernels._libs.get("deform_conv")
        if self.lib is not None:
            kernels._libs["deform_conv"] = self.lib
        try:
            return fn(*args)
        finally:
            if self.lib is not None:
                kernels._libs["deform_conv"] = saved

    def forward(self, x, off, mask, w):
        return self._call(deform.dcn_forward, *(t.permute(0, 3, 1, 2) for t in (x, off, mask)),
                          w.permute(3, 2, 0, 1))

    def backward(self, x, off, mask, w, g):
        return self._call(deform.dcn_backward, *(t.permute(0, 3, 1, 2) for t in (x, off, mask)),
                          w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2))


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def window_inputs(b: int, s: int, dtype, gen, c: int = C, radius: int = 3):
    """K2 / K3 inputs: as ``inputs``, the offsets scaled by radius / 3, with
    the y-offset of every other tap made integral (the hat derivative's
    zero)."""
    x, off, mask, w, g = inputs(b, s, dtype, gen, c)
    off = (off * (radius / 3)).reshape(b, s, s, 9, 2)
    off[:, :, :, 0::2, 0] = off[:, :, :, 0::2, 0].round()
    return x, off.reshape(b, s, s, 18).contiguous(), mask, w, g


class WindowTree:
    """This tree's K2 (``separable``) or K3 through the wrappers of
    ``ops/deform_pallas.py``, NHWC in and out; with ``lib``, a cut copy (or
    a source with this tree's interface) put in the wrappers' place."""

    def __init__(self, separable: bool, lib: ctypes.CDLL | None = None):
        from yolo_ad_refine_tpu_torch.ops import deform_pallas

        self.dp, self.lib = deform_pallas, lib
        self.fwd = "dcn_separable_forward" if separable else "dcn_window_forward"
        self.bwd = "dcn_separable_backward" if separable else "dcn_window_backward"

    def _call(self, fn, *args, **kw):
        saved = kernels._libs.get("deform_window")
        if self.lib is not None:
            kernels._libs["deform_window"] = self.lib
        try:
            return fn(*args, **kw)
        finally:
            if self.lib is not None:
                kernels._libs["deform_window"] = saved

    def forward(self, x, off, mask, w, r):
        y = self._call(self.dp._forward, self.fwd, *(t.permute(0, 3, 1, 2) for t in (x, off, mask)),
                       w.permute(3, 2, 0, 1), r)
        return y.permute(0, 2, 3, 1)

    def backward(self, x, off, mask, w, g, r, rounded=True):
        dx, doff, dmask, dw = self._call(
            self.dp._backward, self.bwd, *(t.permute(0, 3, 1, 2) for t in (x, off, mask)),
            w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), r, rounded=rounded)
        return (dx.permute(0, 2, 3, 1), doff.permute(0, 2, 3, 1), dmask.permute(0, 2, 3, 1),
                dw.permute(2, 3, 1, 0).reshape(w.shape))


class WindowFmaBackward(WindowTree):
    """A deform_window.cu with this tree's forward interface and the earlier
    fp32-core backward's (it exports ``dcn_window_fwd_smem_bytes`` but not
    ``dcn_window_bwd_shape``): the forward through this tree's wrapper, the
    backward as its own wrapper called it, NHWC in and out: the widest
    channel chunk its ``dcn_window_bwd_smem_bytes`` fits into half a
    block's shared memory (two blocks an SM), else into a block's, else
    ValueError."""

    def backward(self, x, off, mask, w, g, r, rounded=True):
        lib = self.lib
        b, h, wd, c = x.shape
        cout = w.shape[-1]
        lib.dcn_window_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.dcn_window_bwd_smem_bytes.argtypes = [ctypes.c_int] * 5
        item = x.element_size()
        vec16 = (c * item) % 16 == 0 and x.data_ptr() % 16 == 0
        step = 16 // item if vec16 else 1
        cap = max(step, 1 << (c - 1).bit_length())
        cands = [cc for cc in (64, 32, 16, 8, 4, 2, 1) if cc % step == 0 and cc <= cap]
        dt = 0 if x.dtype == torch.float32 else 1
        sizes = {cc: lib.dcn_window_bwd_smem_bytes(r, c, cout, cc, dt) for cc in cands}
        fit = [cc for cc in cands if sizes[cc] <= deform.SMEM_PER_BLOCK // 2] or \
            [cc for cc in cands if sizes[cc] <= deform.SMEM_PER_BLOCK]
        if not fit:
            raise ValueError(f"the fp32-core backward does not launch at radius {r}, C={c}, "
                             f"Cout={cout}: {min(sizes.values())} bytes of shared memory")
        wk = w.reshape(KK, c, cout).contiguous()
        f64 = dict(dtype=torch.float64, device=x.device)
        dx, dw = torch.zeros((b, h, wd, c), **f64), torch.zeros((KK, c, cout), **f64)
        doff, dmask = torch.zeros((b, h, wd, 18), **f64), torch.zeros((b, h, wd, KK), **f64)
        fn = getattr(lib, self.bwd)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        st = fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(), wk.data_ptr(), g.data_ptr(),
                dx.data_ptr(), doff.data_ptr(), dmask.data_ptr(), dw.data_ptr(),
                b, h, wd, c, cout, r, max(fit), int(vec16), dt,
                torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, st, "baseline backward")
        if not rounded:
            return dx, doff, dmask, dw.reshape(w.shape)
        return dx.to(x.dtype), doff.float(), dmask.float(), dw.to(w.dtype).reshape(w.shape)


# (kind, dtype, batch, C = Cout, radius): the paths' forward and backward
# at the flagship's width and at scale x's, at the widened reload's radius
# and past the window (the global modes)
F32, BF16 = torch.float32, torch.bfloat16
WINDOW_CASES = (("fwd", F32, 32, C, 3), ("fwd", BF16, 16, C, 3),
                ("bwd", F32, 16, C, 3), ("bwd", BF16, 16, C, 3),
                ("fwd", F32, 16, 384, 3), ("fwd", BF16, 16, 384, 3),
                ("bwd", F32, 16, 384, 3), ("bwd", BF16, 16, 384, 3),
                ("fwd", F32, 8, C, 13), ("fwd", BF16, 8, C, 13),
                ("bwd", F32, 8, C, 13), ("bwd", BF16, 8, C, 13),
                ("fwd", F32, 8, C, 31), ("fwd", BF16, 8, C, 31),
                ("bwd", F32, 8, C, 31), ("bwd", BF16, 8, C, 31))


def case_key(kind, dtype, b, c, r) -> str:
    return f"{kind} {str(dtype).split('.')[1]} B={b}" + (f" C={c}" if c != C else "") + \
        (f" r={r}" if r != 3 else "")


def time_window(impl, data, name: str, kinds=("fwd", "bwd")) -> dict:
    """ms (events) and device ms of the three levels for each case of
    ``kinds``, one launch a level; a case the implementation does not launch
    (ValueError) is recorded with its error."""
    res = {}
    for case in WINDOW_CASES:
        kind, dtype, b, c, r = case
        if kind not in kinds:
            continue
        ms = dev = 0.0
        try:
            for x, off, mask, w, g in data[case[1:]]:
                if kind == "fwd":
                    fn = lambda: impl.forward(x, off, mask, w, r)  # noqa: E731
                else:
                    fn = lambda: impl.backward(x, off, mask, w, g, r)  # noqa: E731
                iters = 20 if kind == "fwd" and c == C else 5
                ms += cuda_time(fn, iters=iters)
                kname = name.replace("forward", "backward") if kind == "bwd" else name
                dev += device_ms(fn, iters=10 if c == C else 3, name=kname)
        except ValueError as err:
            res[case_key(*case)] = {"error": str(err)}
            continue
        res[case_key(*case)] = {"ms": ms, "device_ms": dev}
    return res


def compare_window(base, tree, data, plain) -> dict:
    """Per case, on the 80² level: max |baseline - tree| of the forward and
    of each gradient's fp64 sums; for the backward at C = Cout = 64 also
    each one's max |kernel - plain| / max |plain| per gradient (``plain``:
    the form's plain backward, on the inputs' values in fp32: the function
    both backwards compute, also for bf16 inputs, before the wrappers round
    dx and dweight). A case the baseline does not launch is recorded with
    its error."""
    out = {}
    for case in WINDOW_CASES:
        kind, r = case[0], case[4]
        x, off, mask, w, g = data[case[1:]][0]
        try:
            if kind == "fwd":
                d = (base.forward(x, off, mask, w, r).float()
                     - tree.forward(x, off, mask, w, r).float())
                out[case_key(*case)] = {"out": d.abs().max().item()}
                continue
            got = {"baseline": base.backward(x, off, mask, w, g, r, rounded=False)}
        except ValueError as err:
            out[case_key(*case)] = {"error": str(err)}
            continue
        got["tree"] = tree.backward(x, off, mask, w, g, r, rounded=False)
        res = {n: (a - e).abs().max().item()
               for n, a, e in zip(GRADS, got["baseline"], got["tree"])}
        if case[3] == C:
            want = plain(x.float(), off, mask, w.float(), g.float(), r)
            for impl, grads in got.items():
                res[f"{impl}_vs_plain"] = {
                    n: ((a.float() - e.float()).abs().max() / e.float().abs().max()).item()
                    for n, a, e in zip(GRADS, grads, want)}
        out[case_key(*case)] = res
    return out


def main_window(args, card: str) -> None:
    sep = args.kernel == "separable"
    name = "dcn_separable_forward" if sep else "dcn_window_forward"
    impls = {}
    try:
        report = kernels.build("deform_window")
    except RuntimeError as err:  # the baseline is still timed; the tree's error is shown
        print(f"tree: not built\n{err}", flush=True)
    else:
        for line in report.get("deform_window", {}).get("log", "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas tree: {line.strip()}", flush=True)
        impls["tree"] = WindowTree(sep)
        kernels.load("deform_window")
    sources = {}
    if args.tree_split and "tree" in impls:
        src = kernels.CSRC / "deform_window.cu"
        sources.update({f"tree_{n}": cut_copy(src, n, e) for n, e in WINDOW_TREE_SPLITS.items()})
    if args.baseline:
        sources["baseline"] = args.baseline
    for lname, lib in build(sources, "deform_window").items():
        if not hasattr(lib, "dcn_window_fwd_smem_bytes"):
            raise SystemExit(f"{sources[lname]}: not this tree's forward interface")
        impls[lname] = WindowTree(sep, lib) if hasattr(lib, "dcn_window_bwd_shape") \
            else WindowFmaBackward(sep, lib)

    gen = torch.Generator().manual_seed(0)
    data = {}
    for _, dtype, b, c, r in WINDOW_CASES:
        if (dtype, b, c, r) not in data:
            data[(dtype, b, c, r)] = [window_inputs(b, s, dtype, gen, c, r) for s in LEVELS]
    result = {"card": card, "kernel": args.kernel}
    if "baseline" in impls and "tree" in impls:  # held before anything is timed
        from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_grads_plain

        result["baseline_vs_tree"] = compare_window(
            impls["baseline"], impls["tree"], data,
            lambda *a: window_grads_plain(*a, separable=sep))
        print(f"max |baseline - tree|: {json.dumps(result['baseline_vs_tree'])}", flush=True)
    order = [n for n in impls if n.startswith("tree_")]
    order += [n for n in ("baseline", "tree", "tree", "baseline") if n in impls]
    runs = result["runs"] = []
    for lname in order:
        cut = lname.split("_", 2)[1] if lname.startswith("tree_") else ""
        res = time_window(impls[lname], data, name, (cut,) if cut else ("fwd", "bwd"))
        runs.append({"impl": lname, "ms": res})
        print(f"{lname}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms (device {v['device_ms']:.4f})" if "ms" in v else
            f"{k} not launched ({v['error']})" for k, v in res.items()), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


CASES = (("fwd", torch.float32, 32), ("fwd", torch.bfloat16, 16),
         ("bwd", torch.float32, 16), ("bwd", torch.bfloat16, 16))


def device_ms(fn, iters: int = 10, name: str = "dcn_", per_call: int = 1,
              attempts: int = 5) -> float:
    """Mean device time a call of the kernels whose names hold ``name`` (K1's
    ``dcn_*`` by default) take, from torch.profiler: the kernels alone,
    without the wrapper's host work or its other launches, which CUDA events
    around the call also count. The profiler runs a warm-up cycle of
    ``iters`` calls, then records a second one, idle for 20 ms on either
    side of it (the profiler keeps only records inside its window, on a
    clock of its own); the kernels are read from its trace (the ``kernel``
    events of its Chrome export). The records are counted and must be the
    ``iters * per_call`` launches made (a profiler that drops records would
    read low); the mean is taken over the records. A cycle that lost records
    is profiled again, up to ``attempts`` times, then RuntimeError. The trace
    file is written under ``csrc/build/profile/`` and removed."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    path = kernels.BUILD / "profile" / f"device_ms_{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    count = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.02)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
                prof.step()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        path.unlink()
        durs = [e["dur"] for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
        count = len(durs)
        if count == iters * per_call:
            return sum(durs) / count * per_call / 1e3
    raise RuntimeError(f"device_ms: the profiler kept {count} records of kernels named "
                       f"{name!r}, not the {iters * per_call} launched")


def time_impl(impl, data, kinds=("fwd", "bwd")) -> dict:
    """ms of the three levels for each case of ``kinds``, one launch a level:
    CUDA events around the wrapper's call (``ms``) and the kernels' device
    time (``device_ms``)."""
    res = {}
    for kind, dtype, b in CASES:
        if kind not in kinds:
            continue
        ms = dev = 0.0
        for x, off, mask, w, g in data[(dtype, b)]:
            if kind == "fwd":
                fn = lambda: impl.forward(x, off, mask, w)  # noqa: E731
            else:
                fn = lambda: impl.backward(x, off, mask, w, g)  # noqa: E731
            ms += cuda_time(fn, iters=20 if kind == "fwd" else 10)
            dev += device_ms(fn)
        res[f"{kind} {str(dtype).split('.')[1]} B={b}"] = {"ms": ms, "device_ms": dev}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="an earlier deform_conv.cu (k1) or deform_window.cu to time beside")
    ap.add_argument("--split", action="store_true", help="time cut copies of the baseline bwd")
    ap.add_argument("--tree-split", action="store_true", help="time cut copies of this tree's K1")
    ap.add_argument("--out", type=Path, help="write the results as JSON here")
    ap.add_argument("--kernel", choices=("k1", "separable", "window"), default="k1",
                    help="K1 (deform_conv.cu), or K2 / K3 (deform_window.cu)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_dcn: CUDA is not available; this script runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.kernel != "k1":
        main_window(args, card)
        return

    impls = {}
    try:
        report = kernels.build("deform_conv")
    except RuntimeError as err:  # the baseline is still timed; the tree's error is shown
        print(f"tree: not built\n{err}", flush=True)
    else:
        for line in report.get("deform_conv", {}).get("log", "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas tree: {line.strip()}", flush=True)
        impls["tree"] = Tree()
        kernels.load("deform_conv")
    sources = {}
    if args.tree_split and "tree" in impls:
        src = kernels.CSRC / "deform_conv.cu"
        sources.update({f"tree_{n}": cut_copy(src, n, e) for n, e in TREE_SPLITS.items()})
    if args.baseline:
        sources["baseline"] = args.baseline
        if args.split:
            sources.update({f"baseline_{n}": cut_copy(args.baseline, n, e)
                            for n, e in SPLITS.items()})
    for name, lib in build(sources).items():
        # a source with this tree's C interface (dcn_smem_bytes; the weight
        # as k1_fwd_weight lays it out) runs through this tree's wrappers
        impls[name] = Tree(lib) if name.startswith("tree_") or hasattr(lib, "dcn_smem_bytes") \
            else Baseline(lib)

    gen = torch.Generator().manual_seed(0)
    data = {(dtype, b): [inputs(b, s, dtype, gen) for s in LEVELS]
            for _, dtype, b in CASES}
    # the cut copies first, then the baseline and the tree in turns
    order = [n for n in impls if n.startswith(("baseline_", "tree_"))]
    order += [n for n in ("baseline", "tree", "tree", "baseline") if n in impls]
    runs = []
    for name in order:
        cut = name.split("_", 1)[1] if "_" in name else ""
        kinds = ("fwd",) if cut.startswith("fwd") else ("bwd",) if cut else ("fwd", "bwd")
        res = time_impl(impls[name], data, kinds)
        runs.append({"impl": name, "ms": res})
        print(f"{name}: " + ", ".join(f"{k} {v['ms']:.4f} ms (device {v['device_ms']:.4f})"
                                      for k, v in res.items()), flush=True)
    result = {"card": card, "runs": runs}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
