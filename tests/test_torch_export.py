"""Export and serving in the PyTorch port, fp32 on the CPU: the DCN
dispatcher ops under ``torch.library.opcheck``; the flagship (scale n,
imgsz 128, numpy-randomised weights moved over from the JAX package)
written by ``YOLO.export`` as a checkpoint, a ``torch.export`` program and a
TorchScript program and served by ``AutoBackend``; the exported graphs
holding the ``yat_ad::`` DCN op; a JAX ``Exporter("checkpoint")`` directory
served by the port; the formats that raise; standalone validation through
a backend with a partial final batch; and the Triton route against a mock
KServe-v2 server.

Tolerances: an artifact's output against the eager port 1e-5 of max |ref|
(``torch.export``'s graph runs the same ATen ops, some decomposed, in fp32);
against the JAX model 1e-3 (the slice tests hold the decoded output at
1e-4; here as ROADMAP's item 11 asks); the bf16 program against the eager
model in bf16 one bf16 step of its largest value (2^-8 relative of max
|ref|); backend validation's metrics 1e-6 of the model's own (the same
forward through the artifact).
"""

import copy
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from yolo_ad_refine_tpu.engine.exporter import Exporter as JaxExporter
from yolo_ad_refine_tpu.utils.triton import TritonRemoteModel as JaxTritonRemoteModel
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.build import DataLoader
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.exporter import (
    FORMATS, UNSUPPORTED, AutoBackend, ExportedForward, Exporter, UnsupportedFormat)
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.ops import deform, deform_mxu, deform_pallas
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables
from yolo_ad_refine_tpu_torch.utils.triton import TritonRemoteModel

IMGSZ, BATCH = 128, 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# -- the DCN dispatcher ops ------------------------------------------------------------

@pytest.mark.parametrize("op,radius", [
    ("dcn_forward", None), ("dcn_forward", 2.0), ("dcn_separable_forward", 2),
    ("dcn_window_forward", 2)])
def test_dcn_op_passes_opcheck(op, radius):
    """The CPU implementation, fake implementation and autograd of each
    forward op and of its backward op, through ``torch.library.opcheck``."""
    fwd = getattr(torch.ops.yat_ad, op)
    bwd = getattr(torch.ops.yat_ad, op.replace("forward", "backward"))
    g = torch.Generator().manual_seed(0)
    cl = torch.channels_last
    b, c, cout, h, w = 1, 4, 6, 5, 6
    x = torch.randn(b, c, h, w, generator=g).contiguous(memory_format=cl)
    off = (torch.randn(b, 18, h, w, generator=g) * 1.5).contiguous(memory_format=cl)
    mask = torch.rand(b, 9, h, w, generator=g).contiguous(memory_format=cl)
    wt = torch.randn(cout, c, 3, 3, generator=g) * 0.3
    gy = torch.randn(b, cout, h, w, generator=g).contiguous(memory_format=cl)
    leaves = [t.clone().requires_grad_() for t in (x, off, mask, wt)]
    torch.library.opcheck(fwd.default, (*leaves, radius))
    torch.library.opcheck(bwd.default, (x, off, mask, wt, gy, radius))
    y = fwd(*leaves, radius)
    assert y.is_contiguous(memory_format=cl) and y.shape == (b, cout, h, w)
    grads = torch.autograd.grad(y, leaves, gy)
    for got, want in zip(grads, bwd(x, off, mask, wt, gy, radius)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_public_wrappers_call_their_ops():
    """Each DyDCNv2 route reaches its op: the op's counters stay at 0 on the
    CPU (only a CUDA launch counts)."""
    for mod, name in ((deform, "dcn_forward_op"), (deform_mxu, "dcn_separable_forward_op"),
                      (deform_pallas, "dcn_window_forward_op")):
        op = getattr(mod, name)
        assert op._opoverload.namespace == "yat_ad"
    launches = deform.modulated_deform_conv2d.launches
    x = torch.randn(1, 4, 5, 5).contiguous(memory_format=torch.channels_last)
    off = torch.zeros(1, 18, 5, 5).contiguous(memory_format=torch.channels_last)
    mask = torch.ones(1, 9, 5, 5).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(4, 4, 3, 3)
    ys = [f(x, off, mask, wt) for f in (deform.modulated_deform_conv2d,
                                        deform_mxu.modulated_deform_conv2d_mxu,
                                        deform_pallas.modulated_deform_conv2d_pallas)]
    for y in ys[1:]:  # zero offsets: the three functions agree
        torch.testing.assert_close(y, ys[0], rtol=1e-5, atol=1e-5)
    assert deform.modulated_deform_conv2d.launches == launches


# -- the flagship's artifacts ----------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX model with randomised variables, port YOLO with the same weights,
    an input batch in 0-255, JAX's decoded output for it)."""
    jm, shapes = jax_shapes(FLAGSHIP, IMGSZ)
    variables = randomize(shapes, seed=7)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = YOLO(FLAGSHIP, device="cpu", imgsz=IMGSZ)
    load_jax_variables(port.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.model.eval()
    img = np.random.default_rng(0).integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    y, _ = jax.jit(lambda v, a: jm.apply(v, a.astype(jnp.float32) / 255.0, train=False))(
        jm.variables, jnp.asarray(img))
    return jm, port, img, np.asarray(y)


@pytest.fixture(scope="module")
def eager(pair):
    _, port, img, _ = pair
    with torch.no_grad():
        return ExportedForward(port.model, torch.float32)(torch.from_numpy(img).float()).numpy()


@pytest.fixture(scope="module")
def exported(pair, tmp_path_factory):
    """Each format written once by ``YOLO.export`` (fp32, the default DCN)."""
    port = pair[1]
    tmp = tmp_path_factory.mktemp("export")
    return {fmt: port.export(format=fmt, imgsz=IMGSZ, batch=BATCH, half=False, path=tmp / fmt)
            for fmt in FORMATS}


@pytest.mark.parametrize("fmt", FORMATS)
def test_export_round_trip_matches_the_eager_model_and_jax(pair, eager, exported, fmt):
    _, port, img, want = pair
    path = exported[fmt]
    backend = AutoBackend(path, device="cpu")
    assert backend.kind == fmt and backend.nc == 80 and backend.task == "detect"
    y = backend(img)
    assert y.shape == want.shape == (BATCH, 336, 84) and y.device.type == "cpu"
    assert _rel_err(y.numpy(), eager) <= 1e-5
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-3, atol=1e-3)
    y_float = backend(torch.from_numpy(img).float())  # uint8 and float inputs alike
    torch.testing.assert_close(y_float, y, rtol=0, atol=0)
    if fmt != "checkpoint":
        meta = json.loads(open(f"{path}.meta.json").read())
        assert meta["imgsz"] == IMGSZ and meta["batch"] == BATCH and meta["dtype"] == "float32"
        assert meta["dcn_impl"] == "auto" and meta["dcn_radius"] is None
        assert meta["strides"] == [8, 16, 32] and len(meta["names"]) == 80


def _dcn_calls(backend) -> list[str]:
    """The yat_ad:: ops a loaded program's graph calls, in order."""
    if backend.kind == "torch_export":
        return [str(n.target) for n in backend.program.graph.nodes
                if str(n.target).startswith("yat_ad.")]
    graph = str(backend.program.inlined_graph)
    return [ln.split("= ")[1].split("(")[0] for ln in graph.splitlines() if "yat_ad::" in ln]


@pytest.mark.parametrize("fmt,impl,op", [
    ("torch_export", "auto", "dcn_forward"), ("torchscript", "auto", "dcn_forward"),
    ("torchscript", "pallas", "dcn_window_forward")])  # the card exports a pallas .pt2
def test_exported_graph_holds_the_dcn_op(pair, exported, fmt, impl, op, tmp_path, monkeypatch):
    """The DCN is one op of the graph at each of the three levels (a trace
    that dropped the kernel would hold an empty tensor there), the one the
    variables chose when the program was traced, and the program keeps it
    whatever the variables say when it runs."""
    _, port, img, _ = pair
    monkeypatch.setenv("YAT_DCN_IMPL", impl)
    with torch.no_grad():
        want = ExportedForward(port.model, torch.float32)(torch.from_numpy(img).float())
    path = (exported[fmt] if impl == "auto" else
            Exporter(port.model, imgsz=IMGSZ, batch=BATCH, half=False)(fmt, tmp_path / "m"))
    backend = AutoBackend(path, device="cpu")
    calls = _dcn_calls(backend)
    assert len(calls) == 3 and all(c.replace("::", ".").startswith(f"yat_ad.{op}")
                                   for c in calls), calls
    meta = json.loads(open(f"{path}.meta.json").read())
    assert meta["dcn_impl"] == impl and meta["dcn_op"].endswith(
        {"auto": "conv2d", "pallas": "conv2d_pallas"}[impl])
    assert meta["dcn_radius"] == (None if impl == "auto" else 3)
    monkeypatch.setenv("YAT_DCN_IMPL", "pallas" if impl == "auto" else "auto")
    assert _rel_err(backend(img).numpy(), want.numpy()) <= 1e-5


def test_autobackend_serves_a_jax_checkpoint_export(pair, tmp_path):
    jm, _, img, want = pair
    path = JaxExporter(jm, imgsz=IMGSZ)("checkpoint", tmp_path / "jax_ckpt")
    backend = AutoBackend(path, device="cpu")
    assert backend.kind == "checkpoint" and (path / "weights.msgpack").exists()
    np.testing.assert_allclose(backend(img).numpy(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fmt", [*UNSUPPORTED, "bogus"])
def test_unsupported_format_names_the_ports_formats(tiny, fmt):
    with pytest.raises(UnsupportedFormat, match="unknown format" if fmt == "bogus" else fmt) as e:
        Exporter(tiny)(fmt)
    assert "checkpoint, torch_export, torchscript" in str(e.value)


# -- standalone validation and Triton ----------------------------------------------------

TINY = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                              [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                              [-1, 1, "Conv", [256, 3, 2]]],
        "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]}


@pytest.fixture(scope="module")
def tiny():
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model

    model = build_detection_model(TINY, device="cpu", imgsz=64)
    for m in model.model[-1].cv3:  # the flagship's 0.01 class prior: detections above conf
        m[-1].bias.data.fill_(-4.6)
    return model


@pytest.mark.parametrize("fmt", ["torch_export", "torchscript"])
def test_half_export_runs_in_bf16(tiny, fmt, tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    path = Exporter(tiny, imgsz=64, batch=2, half=True)(fmt, tmp_path / "m")
    assert json.loads(open(f"{path}.meta.json").read())["dtype"] == "bfloat16"
    y = AutoBackend(path, device="cpu")(img)
    with torch.no_grad():
        want = ExportedForward(copy.deepcopy(tiny).to(torch.bfloat16), torch.bfloat16)(
            torch.from_numpy(img).float())
    assert torch.isfinite(y).all() and y.shape == want.shape
    assert _rel_err(y.float().numpy(), want.float().numpy()) <= 2.0 ** -8


def test_backend_validation_pads_the_final_batch(tiny, tmp_path):
    """6 images at batch 4: the artifact's fixed batch takes the final 2
    padded with zero images, and the metrics are the model's own."""
    import cv2

    from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor

    data = make_shapes_dataset(tmp_path / "ds", n_train=2, n_val=6, imgsz=64, max_objects=2)
    # label each image with the model's own 3 best detections (random labels
    # would give mAP 0 on both routes and prove nothing)
    files = sorted((tmp_path / "ds" / data["val"]).glob("*.*"))
    results = DetectionPredictor({"imgsz": 64, "conf": 0.001, "batch": 6})(
        source=[cv2.imread(str(f)) for f in files], model=tiny)
    for f, r in zip(files, results):
        rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b)
                for b, c in zip(r.boxes.xywhn[:3], r.boxes.cls[:3])]
        (f.parent.parent / "labels" / f"{f.stem}.txt").write_text("\n".join(rows) + "\n")
    path = Exporter(tiny, imgsz=64, batch=4, half=False)("torch_export", tmp_path / "m")
    backend = AutoBackend(path, device="cpu")
    calls = []
    backend_fn = backend.program
    backend.program = lambda x: calls.append(tuple(x.shape)) or backend_fn(x)

    def run(**kw):
        ds = YOLODataset(f"{data['path']}/{data['val']}", imgsz=64, augment=False, nc=3,
                         max_boxes=8)
        args = {"imgsz": 64, "iou": 0.7, "max_det": 16, "max_boxes": 8, "batch": 4,
                "conf": 0.001, "task": "detect"}
        return DetectionValidator(args, dataloader=DataLoader(ds, batch_size=4,
                                                              shuffle=False))(**kw)

    got, want = run(backend=backend), run(model=tiny)
    assert calls == [(4, 64, 64, 3), (4, 64, 64, 3)]
    assert want["metrics/mAP50(B)"] > 0
    for k in ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
              "metrics/mAP50-95(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert "val/box_loss" not in got


class _MockTriton(BaseHTTPRequestHandler):
    """A KServe-v2 model ``yolo`` that runs ``self.server.model`` (an
    ``ExportedForward``) on its input."""

    def log_message(self, *a):
        pass

    def _send(self, body: bytes, **headers):
        self.send_response(200)
        for k, v in {"Content-Length": str(len(body)), **headers}.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        assert self.path == "/v2/models/yolo"
        self._send(json.dumps({"name": "yolo", "inputs": [
            {"name": "images", "datatype": "FP32", "shape": [-1, 64, 64, 3]}],
            "outputs": [{"name": "output0", "datatype": "FP32", "shape": [-1]}]}).encode())

    def do_POST(self):
        assert self.path == "/v2/models/yolo/infer"
        raw = self.rfile.read(int(self.headers["Content-Length"]))
        jlen = int(self.headers["Inference-Header-Content-Length"])
        header = json.loads(raw[:jlen])
        x = np.frombuffer(raw[jlen:], np.float32).reshape(header["inputs"][0]["shape"])
        with torch.no_grad():
            y = self.server.model(torch.from_numpy(x.copy())).numpy().astype(np.float32)
        hb = json.dumps({"outputs": [{"name": "output0", "datatype": "FP32",
                                      "shape": list(y.shape),
                                      "parameters": {"binary_data_size": y.nbytes}}]}).encode()
        self._send(hb + y.tobytes(), **{"Inference-Header-Content-Length": str(len(hb))})


@pytest.fixture(scope="module")
def triton_server(tiny):
    srv = HTTPServer(("127.0.0.1", 0), _MockTriton)
    srv.model = ExportedForward(tiny, torch.float32).eval()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_port}"
    srv.shutdown()
    t.join(timeout=10)
    assert not t.is_alive()


def test_triton_backend_serves_a_remote_model(tiny, triton_server):
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    backend = AutoBackend(f"http://{triton_server}/yolo", device="cpu")
    assert backend.kind == "triton"
    with torch.no_grad():
        want = ExportedForward(tiny, torch.float32)(torch.from_numpy(img).float())
    torch.testing.assert_close(backend(img), want, rtol=0, atol=0)
    x = img.astype(np.float32)
    ours = TritonRemoteModel(f"http://{triton_server}/yolo")
    ref = JaxTritonRemoteModel(f"http://{triton_server}/yolo")
    assert (ours.input_names, ours.output_names) == (ref.input_names, ref.output_names)
    for a, b in zip(ours(x), ref(x)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="tritonclient"):
        TritonRemoteModel(f"grpc://{triton_server}/yolo")


def test_sidecar_records_the_head_and_an_older_one_reads_as_detect(tiny, tmp_path):
    """The sidecar records how the validator reads the output (head kind
    and score count); one written without them is a plain detect head,
    whose 4 + nc columns pass the backend's check."""
    path = Exporter(tiny, imgsz=64, batch=2, half=False)("torchscript", tmp_path / "m")
    meta = json.loads(open(f"{path}.meta.json").read())
    assert meta["head"] == "detect" and meta["n_scores"] == meta["nc"] == 3
    old = {k: v for k, v in meta.items() if k not in ("head", "n_scores")}
    open(f"{path}.meta.json", "w").write(json.dumps(old))
    backend = AutoBackend(path, device="cpu")
    assert backend.head == "detect" and backend.n_scores == 3
    data = make_shapes_dataset(tmp_path / "ds", n_train=1, n_val=2, imgsz=64, max_objects=2)
    r = DetectionValidator({"imgsz": 64, "batch": 2, "conf": 0.001, "data": data})(
        backend=backend)
    assert 0.0 <= r["metrics/mAP50(B)"] <= 1.0
