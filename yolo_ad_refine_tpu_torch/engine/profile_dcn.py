"""K1 (the flagship's DCNv2, ``csrc/deform_conv.cu``) on the card: the
kernels of this tree beside those of another source, and where the time of
that source's backward goes.

    python -m yolo_ad_refine_tpu_torch.engine.profile_dcn [--baseline OLD.cu] [--split]

Times K1 fwd in fp32 at batch 32 and in bf16 at batch 16, and K1 bwd in
both at batch 16, each over the flagship's three AYHead levels (80², 40²,
20², C = Cout = 64, offsets N(0, 4²), radius None), as ``chip_smoke.py``
times them: CUDA-event means after warm-up, through the wrappers of
``ops/deform.py`` for this tree. ``--baseline`` names an earlier
``deform_conv.cu`` with the entry points ``dcn_forward`` / ``dcn_backward``,
and either the weight laid out (9, C, Cout) (before the tensor-core K1)
or this tree's C interface (it exports ``dcn_smem_bytes``), which runs
through this tree's wrappers; it is built with the same flags and timed
in turns with this tree's (baseline, tree, tree, baseline).
``--split`` also builds three cut copies of the baseline's backward
(``SPLITS``) and times them: the two C x Cout products alone, the corner
work with the dx scatter and the corner work without it; ``--tree-split``
does the same for this tree's kernels (``TREE_SPLITS``: the forward's
products alone and gather alone, and the backward's three cuts), timed
through this tree's wrappers. Every build's
``-Xptxas -v`` lines (registers, shared memory, spills) are printed. The
copies and their libraries go to ``csrc/build/profile/``. Nothing here is
checked: ``chip_smoke.py`` is the pass/fail run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

from yolo_ad_refine_tpu_torch.ops import deform
from yolo_ad_refine_tpu_torch.utils import kernels

LEVELS = (80, 40, 20)
C = 64
KK = 9

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


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """{name: library} for {name: source}, one nvcc each, all started
    together; prints each build's -Xptxas -v lines."""
    out_dir = kernels.BUILD / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = out_dir / f"lib{name}.so"
        cmd = [kernels.nvcc_path(), *kernels._flags("deform_conv"), "-o", str(so), str(src)]
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
    out = (out_dir or kernels.BUILD / "profile") / f"deform_conv_{split}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def inputs(b: int, s: int, dtype, gen):
    x = torch.randn(b, s, s, C, generator=gen).to("cuda", dtype)
    off = (torch.randn(b, s, s, 18, generator=gen) * 4.0).cuda()
    mask = torch.rand(b, s, s, 9, generator=gen).cuda()
    w = (torch.randn(3, 3, C, C, generator=gen) / math.sqrt(9 * C)).to("cuda", dtype)
    g = torch.randn(b, s, s, C, generator=gen).to("cuda", dtype)
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


CASES = (("fwd", torch.float32, 32), ("fwd", torch.bfloat16, 16),
         ("bwd", torch.float32, 16), ("bwd", torch.bfloat16, 16))


def device_ms(fn, iters: int = 10, name: str = "dcn_") -> float:
    """Mean device time a call of the kernels whose names hold ``name`` (K1's
    ``dcn_*`` by default) take, from torch.profiler: the kernels alone,
    without the wrapper's host work or its other launches, which CUDA events
    around the call also count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages() if name in e.key)
    return us / iters / 1e3


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
    ap.add_argument("--baseline", type=Path, help="an earlier csrc/deform_conv.cu to time beside")
    ap.add_argument("--split", action="store_true", help="time cut copies of the baseline bwd")
    ap.add_argument("--tree-split", action="store_true", help="time cut copies of this tree's K1")
    ap.add_argument("--out", type=Path, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_dcn: CUDA is not available; this script runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
