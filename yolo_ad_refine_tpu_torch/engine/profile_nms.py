"""K4 and K5 (greedy NMS suppression, ``csrc/nms.cu``) on the card: this
tree's kernels beside those of another source, split into mask and walk.

    python -m yolo_ad_refine_tpu_torch.engine.profile_nms [--baseline OLD_nms.cu] [--split]
        [--out FILE]

Times ``suppress`` (K4) and ``suppress_rotated`` (K5) through the wrappers of
``ops/nms.py`` on three sets of candidates, iou 0.7:

- ``chip_smoke.py``'s synthetic candidates (``synthetic_candidates``,
  ``synthetic_rotated_candidates``): K4 at B = 32, K = 2048 and K5 at
  B = 16, K = 2048, conf 0.001;
- the candidates of one flagship predict batch (32 seeded images of mixed
  shapes at imgsz 640, seeded weights), at conf 0.001 and 0.25;
- those of one yolo11n-obb predict batch (16 seeded 1024² tiles, seeded
  weights, the class biases at the flagship's 0.01 prior as in
  ``chip_smoke.py``), at conf 0.001 and 0.25.

Each case reports CUDA-event ms around the wrapper's call (mean of 20 after
warm-up) and torch.profiler device ms of the mask kernel
(``*mask_kernel``) and of the walk (``*reduce_kernel``), each the mean of
the launches the profiler recorded (``launch_ms``). ``--baseline`` names
an earlier ``nms.cu`` with the same C entry points; it is built with this
tree's flags into ``csrc/build/profile/`` and run through this tree's
wrappers, in turns with this tree's source (baseline, tree, tree,
baseline), and each keep mask is compared with the first run's.
``--split`` also builds cut copies of this tree's source (``SPLITS``) and
times them first; their keep masks are wrong by design. Nothing here is
checked: ``chip_smoke.py`` is the pass/fail run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.engine.profile_dcn import cuda_time, cut_copy
from yolo_ad_refine_tpu_torch.ops.nms import select_candidates, suppress, suppress_rotated
from yolo_ad_refine_tpu_torch.utils import kernels

FLAGSHIP = "yolo11-701-YOLO-AD-Refine.yaml"
OBB_CFG = "yolo11n-obb.yaml"
OBB_IMGSZ = 1024
IOU = 0.7

# cut copies of this tree's csrc/nms.cu, for timing only (their keep masks
# are wrong): (text in the source, its replacement)
SPLITS = {
    # the walk without the other warps' ORs into words t + 2 on
    "walk_no_bulk": [("if (nk == 0 || w >= nwords) return;", "return;")],
    # the mask kernel without its pairs: launch, tile numbering, loads and stores remain
    "mask_no_pairs": [("for (int jj = 0; jj < TB; ++jj) {\n    const float4 q",
                       "for (int jj = 0; jj < 0; ++jj) {\n    const float4 q")],
}


def synthetic_candidates(b: int, k: int, gen, dev):
    """(B, K, 4) score-sorted xyxy over 600 px with the class offsets of 8
    classes and (B, K) scores on a 1/64 grid, for ties."""
    cxy = torch.rand(b, k, 2, generator=gen) * 600
    wh = torch.rand(b, k, 2, generator=gen) * 120 + 4
    cls = torch.randint(0, 8, (b, k, 1), generator=gen).float() * 7680.0  # class offsets
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1) + cls
    scores = (torch.rand(b, k, generator=gen) * 64).round() / 64  # many ties
    scores = scores.sort(dim=1, descending=True, stable=True).values
    return boxes.to(dev).contiguous(), scores.to(dev).contiguous()


def synthetic_rotated_candidates(b: int, k: int, gen, dev):
    """(B, K, 5) score-sorted xywhr over 1024 px with the class offsets of
    15 classes (centres up to about 108k px) and (B, K) scores on a 1/64
    grid, for ties."""
    xy = torch.rand(b, k, 2, generator=gen) * OBB_IMGSZ
    wh = torch.rand(b, k, 2, generator=gen) * 112 + 8
    ang = torch.rand(b, k, 1, generator=gen) * math.pi - math.pi / 4
    cls = torch.randint(0, 15, (b, k, 1), generator=gen).float() * 7680.0
    scores = (torch.rand(b, k, generator=gen) * 64).round() / 64
    scores = scores.sort(dim=1, descending=True, stable=True).values
    return torch.cat([xy + cls, wh, ang], -1).to(dev).contiguous(), scores.to(dev).contiguous()


def predict_candidates(model, imgs, imgsz: int, confs, rotated: bool = False,
                       multi_label: bool = False) -> dict:
    """{conf: (boxes, scores)}, the suppression's input for one predict batch
    of ``imgs`` through the port's ``YOLO`` ``model`` at each conf, over the
    model's score columns (a YOLO-World vocabulary's); ``multi_label`` as
    the validator selects them."""
    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess

    dev = next(model.model.parameters()).device
    x, _ = preprocess(imgs, imgsz, len(imgs), dev, torch.float32)
    with torch.inference_mode():
        y = model.model(x)[0]
    return {c: select_candidates(y, c, nc=model.model.n_scores, rotated=rotated,
                                 multi_label=multi_label)[:2] for c in confs}


def _real_cases(dev) -> dict:
    """The flagship's and yolo11n-obb's predict-batch candidates."""
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.profile_predict import SHAPES

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*SHAPES[i % len(SHAPES)], 3), dtype=np.uint8) for i in range(32)]
    flag = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    cases = {f"K4 flagship batch conf {c}": ("K4", *v)
             for c, v in predict_candidates(flag, imgs, 640, (0.001, 0.25)).items()}
    obb = YOLO(OBB_CFG, task="obb", device=dev, imgsz=OBB_IMGSZ, seed=0)
    with torch.no_grad():  # the flagship head's class prior, as chip_smoke.py sets it
        for seq in obb.model.model[obb.model.head_idx].cv3:
            seq[-1].bias.fill_(-math.log((1 - 0.01) / 0.01))
    tiles = [rng.integers(0, 256, (OBB_IMGSZ, OBB_IMGSZ, 3), dtype=np.uint8) for _ in range(16)]
    cases.update({f"K5 yolo11n-obb batch conf {c}": ("K5", *v) for c, v in predict_candidates(
        obb, tiles, OBB_IMGSZ, (0.001, 0.25), rotated=True).items()})
    return cases


class Impl:
    """The wrappers of ops/nms.py; with ``lib``, another nms.cu's library
    put in the wrappers' place for each call."""

    def __init__(self, lib: ctypes.CDLL | None = None):
        self.lib = lib

    def __call__(self, kernel: str, data, scores, conf: float):
        fn = suppress if kernel == "K4" else suppress_rotated
        saved = kernels._libs.get("nms")
        if self.lib is not None:
            kernels._libs["nms"] = self.lib
        try:
            return fn(data, scores, IOU, conf)
        finally:
            if self.lib is not None:
                kernels._libs["nms"] = saved


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """{name: library} for {name: nms source}, built with this tree's nms
    flags into csrc/build/profile/, one nvcc each, all started together;
    prints each build's -Xptxas -v lines."""
    out_dir = kernels.BUILD / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = out_dir / f"libnms_{name}.so"
        cmd = [kernels.nvcc_path(), *kernels._flags("nms"), "-o", str(so), str(src)]
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


def launch_ms(fn, names, iters: int = 10, windows: int = 3) -> dict:
    """{name: mean device ms of one launch} of the kernels whose names hold
    each of ``names``, from a torch.profiler window of ``iters`` calls of
    ``fn``. The mean is over the launches the profiler recorded: in a long
    process it drops some kernel records, so a sum over ``iters`` would read
    low. A window that recorded no launch of a name is taken again, up to
    ``windows`` times; then it raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        got = {n: [(e.device_time_total, e.count) for e in events if n in e.key] for n in names}
        if all(sum(c for _, c in v) for v in got.values()):
            return {n: sum(us for us, _ in v) / sum(c for _, c in v) / 1e3
                    for n, v in got.items()}
    raise RuntimeError(f"torch.profiler recorded no launch of one of {names} in {windows} "
                       f"windows")


def time_case(impl, kernel: str, data, scores, conf: float) -> dict:
    """CUDA-event ms of the wrapper's call and the device ms of its mask and
    walk kernels (one launch of each a call), the kept count and the keep
    mask."""
    fn = lambda: impl(kernel, data, scores, conf)  # noqa: E731
    keep = fn()
    dev = launch_ms(fn, ("mask_kernel", "reduce_kernel"))
    mask, walk = dev["mask_kernel"], dev["reduce_kernel"]
    return {"ms": cuda_time(fn, iters=20), "device_ms": mask + walk, "mask_ms": mask,
            "walk_ms": walk, "kept": int(keep.sum()), "valid": int((scores > conf).sum()),
            "keep": keep}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier csrc/nms.cu to time beside")
    ap.add_argument("--split", action="store_true", help="time cut copies of this tree's nms.cu")
    ap.add_argument("--out", type=Path, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_nms: CUDA is not available; this script runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"

    impls = {}
    try:
        report = kernels.build("nms")
    except RuntimeError as err:  # the baseline is still timed; the tree's error is shown
        print(f"tree: not built\n{err}", flush=True)
    else:
        for line in report.get("nms", {}).get("log", "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas tree: {line.strip()}", flush=True)
        impls["tree"] = Impl()
    sources = {"baseline": args.baseline} if args.baseline else {}
    if args.split:
        sources.update({n: cut_copy(kernels.CSRC / "nms.cu", n, e) for n, e in SPLITS.items()})
    impls.update({n: Impl(lib) for n, lib in build(sources).items()})

    gen = torch.Generator().manual_seed(0)
    cases = {"K4 synthetic B=32 K=2048 conf 0.001": ("K4", *synthetic_candidates(32, 2048, gen,
                                                                                  dev)),
             "K5 synthetic B=16 K=2048 conf 0.001": ("K5", *synthetic_rotated_candidates(
                 16, 2048, gen, dev))}
    cases = {k: (*v, 0.001) for k, v in cases.items()}
    cases.update({k: (*v, float(k.rsplit(" ", 1)[1])) for k, v in _real_cases(dev).items()})
    for name, (kernel, data, scores, conf) in cases.items():
        print(f"{name}: B={scores.shape[0]} K={scores.shape[1]}, "
              f"{int((scores > conf).sum())} valid candidates", flush=True)

    # the cut copies first, then the baseline and the tree in turns
    order = [n for n in SPLITS if n in impls]
    order += [n for n in ("baseline", "tree", "tree", "baseline") if n in impls]
    runs, first_keep = [], {}
    for impl in order:
        res = {}
        for name, (kernel, data, scores, conf) in cases.items():
            t = time_case(impls[impl], kernel, data, scores, conf)
            keep = t.pop("keep")
            if impl not in SPLITS:  # the first whole source's keep mask is the reference
                t["keep_equal_first_run"] = bool(torch.equal(keep, first_keep.setdefault(name,
                                                                                          keep)))
            res[name] = t
            print(f"{impl} {name}: {t['ms']:.4f} ms (device {t['device_ms']:.4f}: mask "
                  f"{t['mask_ms']:.4f}, walk {t['walk_ms']:.4f}), {t['kept']} kept of "
                  f"{t['valid']} valid, keep equal to the first run's: "
                  f"{t.get('keep_equal_first_run', '-')}", flush=True)
        runs.append({"impl": impl, "cases": res})
    result = {"card": card, "runs": runs}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
