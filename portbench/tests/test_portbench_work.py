"""The yardstick's counts against small cases worked by hand."""

from __future__ import annotations

import pytest

from portbench import work

BW, FP32, TF32, BF16 = 3.35e12, 67e12, 495e12, 989e12


def test_k1_forward_bound_by_hand():
    # B=1, C=Cout=2, 1x1 map: bytes 4*(1*(2+2) + 9*2*2) + 4*27 = 16 + 144 + 108 = 268;
    # products 2*9*2*2 = 72 on 3xTF32, sampling 9*2*8 + 180 = 324 on the fp32 cores
    shapes = [[1, 2, 1, 1], [1, 18, 1, 1], [1, 9, 1, 1], [2, 2, 3, 3]]
    assert work.k1_fwd_bound_s(shapes, 4) == pytest.approx(max(268 / BW, 3 * 72 / TF32 + 324 / FP32))
    # bf16: bytes 2*(4 + 36) + 108 = 188; products on the bf16 cores
    assert work.k1_fwd_bound_s(shapes, 2) == pytest.approx(max(188 / BW, 72 / BF16 + 324 / FP32))


def test_k1_forward_bound_at_scale_is_operation_bound():
    # the flagship x's P3 call: B=48, C=Cout=384, 80x80, bf16
    shapes = [[48, 384, 80, 80], [48, 18, 80, 80], [48, 9, 80, 80], [384, 384, 3, 3]]
    px = 48 * 80 * 80
    t = work.k1_fwd_bound_s(shapes, 2)
    assert t == pytest.approx(px * 2 * 9 * 384 * 384 / BF16 + px * (9 * 384 * 8 + 180) / FP32)


def test_k1_backward_bound_by_hand():
    # B=1, C=2, Cout=3, 1x1: bytes 4*(2+3+2) + 4*27*2 + 4*9*2*3*2 = 28 + 216 + 432 = 676;
    # products 9*4*2*3 = 216 on 3xTF32, the rest 9*(24*2+30) = 702 on the fp32 cores
    shapes = [[1, 2, 1, 1], [1, 18, 1, 1], [1, 9, 1, 1], [3, 2, 3, 3]]
    assert work.k1_bwd_bound_s(shapes, 4) == pytest.approx(
        max(676 / BW, 3 * 216 / TF32 + 702 / FP32))
    # bf16: half the products in bf16, half as three bf16 products
    assert work.k1_bwd_bound_s(shapes, 2) == pytest.approx(
        max((2 * 7 + 216 + 2 * 108) / BW, 108 / BF16 + 3 * 108 / BF16 + 702 / FP32))


def test_k4_bound_by_hand():
    # two images: 5 candidates of which 2 kept, 3 of which 3 kept:
    # pairs (1 + 3) + (3 + 0) = 7; ops 15*7 + 3*8 = 129; bytes 21*8 = 168
    assert work.k4_bound_s([5, 3], [2, 3]) == pytest.approx(max(168 / BW, 129 / FP32))
    assert work.k4_bound_s([0], [0]) == 0.0


def test_dtype_sizes_and_families():
    assert work.itemsize("c10::BFloat16") == 2 and work.itemsize("float") == 4
    assert work.kernel_family("void dcn_fwd_kernel<true, 8>(...)") == "K1_dcn_forward"
    assert work.kernel_family("void dcn_bwd_kernel<true, 8, false, true>(...)") == "K1_dcn_backward"
    assert work.kernel_family("nms_suppress_mask") == "K4_nms_suppress"
    assert work.kernel_family("sm90_xmma_fprop_implicit_gemm") == "convolution"
    assert work.kernel_family("mystery") == "other"


def test_dcn_roofline_sums_calls_of_one_op():
    shapes = [[1, 2, 1, 1], [1, 18, 1, 1], [1, 9, 1, 1], [2, 2, 3, 3]]
    ops = [{"name": "yat_ad::dcn_forward", "shapes": shapes, "dtypes": ["float"]},
           {"name": "yat_ad::dcn_forward", "shapes": shapes, "dtypes": ["c10::BFloat16"]},
           {"name": "yat_ad::dcn_backward", "shapes": shapes, "dtypes": ["float"]}]
    trace = {"ops": ops, "families": {"K1_dcn_forward": 4e-6}}
    got = work.dcn_roofline_pct(trace, "yat_ad::dcn_forward", "K1_dcn_forward",
                                work.k1_fwd_bound_s)
    want = work.k1_fwd_bound_s(shapes, 4) + work.k1_fwd_bound_s(shapes, 2)
    assert got == pytest.approx(100 * want / 4e-6)
    assert work.dcn_roofline_pct({"ops": [], "families": {}}, "yat_ad::dcn_forward",
                                 "K1_dcn_forward", work.k1_fwd_bound_s) is None


def test_forward_flops_counts_the_flagship():
    cfg = {"yaml_path": str(work.__file__).replace("work.py",
                                                    "reference/yolo11-701-YOLO-AD-Refine.yaml"),
           "scale": "n"}
    assert work.forward_flops(cfg, 640) / 1e9 == pytest.approx(12.48, abs=0.01)
