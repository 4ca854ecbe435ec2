"""The yardstick's arithmetic: the card's peaks, the kernel families, what a
kernel call must move and compute, and a forward's operations.

Frozen copies: the family table of the port's
``engine/profile_predict.py``; the K1 and K4 work of ``chip_smoke.py``
(``dcn_fwd_bound``, ``k1_bwd_work``, ``bwd_bound``, ``k4_bound``), widened
to C != Cout and with K4 counted over the candidates this data has; the
forward's operations counted as ``utils/benchmarks.py model_flops`` counts
them (FlopCounterMode, 2 FLOPs a multiply-add; the reference's DCN is a
plain matrix product, so the counter sees its 2·B·H·W·9·C·Cout itself).
Nothing here reads the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}

# (family, substrings of the lower-cased kernel name), first match wins
FAMILIES = (("K1_dcn_forward", ("dcn_fwd",)), ("K1_dcn_backward", ("dcn_bwd",)),
            ("K2_dcn_separable_forward", ("dcn_separable_forward",)),
            ("K2_dcn_separable_backward", ("dcn_separable_backward",)),
            ("K3_dcn_window_forward", ("dcn_window_forward",)),
            ("K3_dcn_window_backward", ("dcn_window_backward",)),
            ("K5_nms_rotated", ("nms_rotated",)), ("K4_nms_suppress", ("nms_",)),
            ("LAP", ("lap_kernel",)),
            ("normalisation", ("norm", "bn_fw")),
            ("layout_change", ("nhwctonchw", "nchwtonhwc", "transpose")),
            ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn")),
            ("fft", ("fft",)), ("matmul", ("gemm", "gemv")), ("sort_scan", ("sort", "scan")),
            ("reduction", ("reduce",)), ("copy", ("copy", "memcpy", "memset")),
            ("elementwise", ("elementwise", "vectorized")))


def kernel_family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in FAMILIES if any(k in low for k in keys)), "other")


def products_s(flops: float, route: str) -> float:
    """Seconds for GEMM-shaped products on one route: "bf16" the tensor
    cores in bf16; "3xtf32" three TF32 products (fp32 accuracy, the fastest
    exact route for fp32); "3xbf16" an fp32 operand split into three bf16
    parts against a bf16 one."""
    return {"bf16": flops / PEAK_FLOPS["bf16"], "3xtf32": 3 * flops / PEAK_FLOPS["tf32"],
            "3xbf16": 3 * flops / PEAK_FLOPS["bf16"]}[route]


def _dims(shapes):
    """(B, H, W, C, Cout) of a DCN call from its inputs' shapes: x (B, C,
    H, W), offset, mask, weight (Cout, C, 3, 3)."""
    b, c, h, w = shapes[0]
    return b, h, w, c, shapes[3][0]


def k1_fwd_bound_s(shapes, itemsize: int) -> float:
    """Least seconds of a K1 forward call: x, offset, mask and weight read
    once, the output written once (offset and mask fp32), against the
    products 2·9·C·Cout a pixel on the fastest exact route of the type plus
    the sampling, ~9·C·8 + 9·20 FLOPs a pixel, on the fp32 cores."""
    b, h, w, c, cout = _dims(shapes)
    px = b * h * w
    nbytes = itemsize * (px * (c + cout) + 9 * c * cout) + 4 * px * (18 + 9)
    products = px * 2 * 9 * c * cout
    route = "3xtf32" if itemsize == 4 else "bf16"
    t_ops = products_s(products, route) + px * (9 * c * 8 + 9 * 20) / PEAK_FLOPS["fp32"]
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def k1_bwd_bound_s(shapes, itemsize: int) -> float:
    """Least seconds of a K1 backward call: x, offset, mask, weight and the
    incoming gradient read once, dx, doffset, dmask and dweight written
    once; the two C x Cout products a pixel and tap (g·W_t^T and the dW_t
    update) on the fastest exact route (bf16 inputs: one in bf16, the other
    against the fp32 sample split in three), the sampling recompute, the
    corner products and the scatter (~24·C + 30 FLOPs a tap) on the fp32
    cores. ``shapes`` are the forward's inputs'."""
    b, h, w, c, cout = _dims(shapes)
    px = b * h * w
    nbytes = (itemsize * px * (c + cout + c) + 4 * px * 27 * 2 + itemsize * 9 * c * cout * 2)
    products = px * 9 * 4 * c * cout
    fast = (products_s(products, "3xtf32") if itemsize == 4 else
            products_s(products / 2, "bf16") + products_s(products / 2, "3xbf16"))
    t_ops = fast + px * 9 * (24 * c + 30) / PEAK_FLOPS["fp32"]
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def k4_bound_s(valid: list[int], kept: list[int]) -> float:
    """Least seconds of K4 over a batch whose images have ``valid``
    candidates over conf and ``kept`` rows: each kept row's IoU against
    every other kept one (to show that none suppresses it) and one IoU for
    each suppressed candidate, 15 FLOPs an IoU and 3 a candidate, on the
    fp32 cores, against each candidate's box, score and keep flag (21
    bytes) moved once."""
    pairs = sum(k * (k - 1) // 2 + (v - k) for v, k in zip(valid, kept))
    ops = 15 * pairs + 3 * sum(valid)
    return max(21 * sum(valid) / HBM_BYTES_PER_S, ops / PEAK_FLOPS["fp32"])


def forward_flops(cfg: dict, imgsz: int) -> float:
    """FLOPs of one eval forward of the reference at ``cfg``'s scale on one
    imgsz² image, counted by FlopCounterMode on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.model import build

    model = build(cfg["yaml_path"], cfg["scale"], device="meta").eval()
    x = torch.zeros((1, 3, imgsz, imgsz), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return float(counter.get_total_flops())


def itemsize(dtype: str) -> int:
    """Bytes of an element of a profiler's dtype name ("float",
    "c10::BFloat16", ...)."""
    return 2 if any(k in dtype for k in ("BFloat16", "Half")) else 4


def dcn_roofline_pct(trace: dict, op: str, family: str, bound) -> float | None:
    """The calls of dispatcher op ``op`` in a traced window: the sum of
    their bounds (``bound(shapes, itemsize)``, from each call's shapes and
    type) over the device time of the op's kernel family, in %; None where
    the window has no such call or kernel."""
    calls = [c for c in trace["ops"] if c["name"] == op]
    device_s = trace["families"].get(family, 0.0)
    if not calls or not device_s:
        return None
    return 100.0 * sum(bound(c["shapes"], itemsize(c["dtypes"][0])) for c in calls) / device_s
