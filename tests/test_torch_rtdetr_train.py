"""RT-DETR training in the PyTorch port against the JAX package: the batched
LAP's plain version, the denoising group, RTDETRLoss and its gradients, and
a tiny training run through ``YOLO.train``, fp32 on the CPU.

Tolerances: the LAP's cost equal to scipy's optimum (1e-3 absolute, fp32
sums), its assignment equal to JAX's where the optimum is unique (random
costs) and on JAX's own tie rule (integer costs); the denoising group's
construction equal to JAX's (1e-6) given JAX's noise arrays; one step's
loss 1e-5 relative and each gradient leaf 1e-4 relative norm against JAX,
with JAX's denoising dict injected on both sides (its noise comes from a
JAX PRNG, which the port does not reproduce; the port's own draw is held
by its layout and ranges).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from test_torch_rtdetr import TINY
from test_torch_weights import jax_shapes, randomize
from yolo_ad_refine_tpu.ops.lap import linear_sum_assignment as jax_lsa
from yolo_ad_refine_tpu.train import rtdetr as JR
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.dataset import check_task
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.ops.lap import linear_sum_assignment, linear_sum_assignment_plain
from yolo_ad_refine_tpu_torch.train import rtdetr as PR
from yolo_ad_refine_tpu_torch.utils import yaml_save
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port, load_jax_variables

IMGSZ, NC, MAXB = 64, 3, 8


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("masked", [False, True])
def test_lap_plain_is_optimal_and_equals_jax(masked):
    r = np.random.default_rng(7)
    c = (r.standard_normal((4, 12, 40)) * 5).astype(np.float32)
    mask = (r.random((4, 12)) < 0.6).astype(np.float32) if masked else np.ones((4, 12), np.float32)
    got = linear_sum_assignment(torch.from_numpy(c), torch.from_numpy(mask) if masked else None)
    got = got.numpy()
    want = np.asarray(jax_lsa(jnp.asarray(c), jnp.asarray(mask) if masked else None))
    for b in range(4):
        v = mask[b] > 0
        assert len(set(got[b].tolist())) == 12  # distinct columns, padded rows too
        ri, ci = scipy_lsa(c[b][v])
        assert np.isclose(c[b][v, got[b][v]].sum(), c[b][v][ri, ci].sum(), atol=1e-3)
        np.testing.assert_array_equal(got[b][v], want[b][v])  # a unique optimum


def test_lap_plain_breaks_ties_as_jax():
    """Integer costs tie everywhere: an unassigned column wins, then the
    lowest index, as in the JAX solver."""
    c = np.random.default_rng(3).integers(0, 3, (3, 10, 30)).astype(np.float32)
    got = linear_sum_assignment_plain(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_lsa(jnp.asarray(c))))


def test_lap_padded_rows_take_the_lowest_free_columns():
    c = np.random.default_rng(4).standard_normal((1, 5, 9)).astype(np.float32)
    mask = torch.tensor([[0.0, 1.0, 0.0, 1.0, 0.0]])
    got, scans = linear_sum_assignment_plain(torch.from_numpy(c), mask, return_scans=True)
    got = got[0].tolist()
    free = [j for j in range(9) if j not in (got[1], got[3])]
    assert [got[0], got[2], got[4]] == free[:3] and int(scans[0]) >= 2
    with pytest.raises(ValueError, match="M <= N"):
        linear_sum_assignment(torch.zeros(1, 4, 3))


@pytest.mark.parametrize("max_boxes,num_dn,nq", [(8, 32, 30), (8, 100, 30), (128, 100, 300)])
def test_dn_layout_and_blocked_mask_equal_jax(max_boxes, num_dn, nq):
    """At max_boxes 128 the group is one pair of 128: ndn 256, T 556."""
    cfg, jcfg = PR.make_dn_config(max_boxes, num_dn), JR.make_dn_config(max_boxes, num_dn)
    assert tuple(cfg) == tuple(jcfg) and cfg.ndn == jcfg.ndn
    got = PR.build_dn_attn_blocked(cfg, nq)
    np.testing.assert_array_equal(got, JR.build_dn_attn_blocked(jcfg, nq))
    if max_boxes == 128:
        assert cfg.ndn == 256 and got.shape == (556, 556)


def _targets(b=2, seed=0):
    r = np.random.default_rng(seed)
    xy = r.uniform(2, 36, (b, MAXB, 2))
    boxes = np.concatenate([xy, xy + r.uniform(6, 26, (b, MAXB, 2))], -1).astype(np.float32)
    mask = (np.arange(MAXB)[None, :, None] < np.array([5, 3])[:b, None, None]).astype(np.float32)
    cls = r.integers(0, NC, (b, MAXB, 1)).astype(np.float32)
    return cls, boxes * mask, mask


def _jax_noise(rng, shape, nc, cfg):
    """The JAX make_cdn_group's own draws, in its order, as numpy."""
    r_cls, r_new, r_sign, r_part = jax.random.split(rng, 4)
    return {"flip": np.asarray(jax.random.uniform(r_cls, shape) < cfg.cls_noise_ratio * 0.5),
            "new_label": np.asarray(jax.random.randint(r_new, shape, 0, nc)),
            "sign": np.asarray(jax.random.randint(r_sign, (*shape, 4), 0, 2) * 2.0 - 1.0),
            "part": np.asarray(jax.random.uniform(r_part, (*shape, 4)))}


def test_cdn_construction_equals_jax_given_its_noise():
    cls, boxes, mask = _targets()
    cfg = JR.make_dn_config(MAXB, 32)
    blocked = JR.build_dn_attn_blocked(cfg, 30)
    rng = jax.random.PRNGKey(5)
    want = JR.make_cdn_group(jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), rng, nc=NC,
                             imgsz=float(IMGSZ), cfg=cfg, attn_blocked=jnp.asarray(blocked))
    noise = {k: torch.from_numpy(np.asarray(v)) for k, v in
             _jax_noise(rng, (2, cfg.num_group, 2, MAXB), NC, cfg).items()}
    got = PR.build_cdn_group(torch.from_numpy(cls), torch.from_numpy(boxes),
                             torch.from_numpy(mask), noise, imgsz=float(IMGSZ),
                             cfg=PR.make_dn_config(MAXB, 32),
                             attn_blocked=torch.from_numpy(blocked))
    np.testing.assert_array_equal(got["cls"].numpy(), np.asarray(want["cls"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["bbox_logit"].numpy(), np.asarray(want["bbox_logit"]),
                               atol=1e-6, rtol=1e-6)


def test_own_draw_layout_and_noise_ranges():
    """The port's draw: the validity mirrors the GT mask in every slot,
    about a quarter of the labels are redrawn, a positive's corners move by
    at most half the box's side and a negative's by half to one side
    (where neither the clip to the image nor crossed sides intervene)."""
    cls, boxes, mask = _targets()
    cfg = PR.make_dn_config(MAXB, 100)  # 12 group pairs
    gen = torch.Generator().manual_seed(0)
    noise = PR.draw_cdn_noise(2, NC, cfg, gen)
    assert noise["flip"].shape == (2, 12, 2, MAXB) and noise["part"].shape == (2, 12, 2, MAXB, 4)
    assert set(noise["sign"].unique().tolist()) == {-1.0, 1.0}
    assert 0.15 < noise["flip"].float().mean() < 0.35
    assert 0 <= int(noise["new_label"].min()) and int(noise["new_label"].max()) < NC
    dn = PR.build_cdn_group(torch.from_numpy(cls), torch.from_numpy(boxes),
                            torch.from_numpy(mask), noise, imgsz=float(IMGSZ), cfg=cfg,
                            attn_blocked=torch.zeros(1))
    v = dn["valid"].reshape(2, 12, 2, MAXB)
    assert torch.equal(v, torch.from_numpy(mask[..., 0])[:, None, None].expand_as(v))
    box = torch.sigmoid(dn["bbox_logit"]).reshape(2, 12, 2, MAXB, 4)
    gt = torch.from_numpy(boxes) / IMGSZ
    xyxy = torch.cat([box[..., :2] - box[..., 2:] / 2, box[..., :2] + box[..., 2:] / 2], -1)
    half = ((gt[..., 2:] - gt[..., :2]) / 2).repeat(1, 1, 2)
    move = (xyxy - gt[:, None, None]).abs() / half[:, None, None].clamp(min=1e-6)
    # corners clipped to the image, and negatives whose sides crossed (their
    # width or height clamps to 1e-6), lose the relation
    inside = (xyxy > 1e-4) & (xyxy < 1 - 1e-4) & (box[..., 2:] > 1e-5).all(-1, keepdim=True)
    ok = torch.from_numpy(mask[..., 0] > 0)[:, None, None, :, None] & inside
    pos, neg = move[:, :, 0][ok[:, :, 0]], move[:, :, 1][ok[:, :, 1]]
    assert pos.max() <= 1.0 + 1e-3 and neg.min() >= 1.0 - 1e-3 and neg.max() <= 2.0 + 1e-3


def test_dn_groups_stay_blind_to_each_other():
    """With the blocked mask, redrawing group 1's queries changes neither
    group 0's outputs nor the selected queries', and the selected queries'
    outputs equal a forward without the denoising group."""
    torch.manual_seed(0)
    port = DetectionModel(dict(TINY)).train()
    cls, boxes, mask = (torch.from_numpy(a) for a in _targets())
    cfg = PR.make_dn_config(MAXB, 16)  # two group pairs of 16 queries
    blocked = torch.from_numpy(PR.build_dn_attn_blocked(cfg, 30))
    x = torch.rand(2, 3, IMGSZ, IMGSZ, generator=torch.Generator().manual_seed(1))

    def run(seed):
        dn = PR.make_cdn_group(cls, boxes, mask, torch.Generator().manual_seed(seed), nc=NC,
                               imgsz=float(IMGSZ), cfg=cfg, attn_blocked=blocked)
        if seed:  # group 0 kept, group 1 redrawn
            base = PR.make_cdn_group(cls, boxes, mask, torch.Generator().manual_seed(0), nc=NC,
                                     imgsz=float(IMGSZ), cfg=cfg, attn_blocked=blocked)
            for k in ("cls", "bbox_logit", "valid"):
                dn[k][:, :16] = base[k][:, :16]
        m = copy.deepcopy(port)
        with torch.no_grad():
            return m(x, dn=dn)[0][-1]  # the last layer's boxes (B, T, 4)

    a, b = run(0), run(1)
    assert not torch.allclose(a[:, 16:32], b[:, 16:32])  # group 1 did change
    torch.testing.assert_close(a[:, :16], b[:, :16], rtol=0, atol=1e-6)
    torch.testing.assert_close(a[:, 32:], b[:, 32:], rtol=0, atol=1e-6)
    with torch.no_grad():
        plain = copy.deepcopy(port)(x)[0][-1]
    torch.testing.assert_close(a[:, 32:], plain, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_models():
    jm, shapes = jax_shapes(TINY, IMGSZ)
    variables = randomize(shapes, seed=21)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = DetectionModel(dict(TINY))
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    return jm, port


def test_loss_and_gradients_match_jax_with_its_dn(tiny_models):
    """One train-mode forward with JAX's denoising dict (12 group pairs,
    ndn 192, T 222) and RTDETRLoss: the total, the components and every
    parameter's gradient against JAX's. The values are the same in train
    and eval; the gradients stop where the JAX decoder's do."""
    jm, port = tiny_models
    cls, boxes, mask = _targets(seed=1)
    img = np.random.default_rng(2).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    jloss = JR.RTDETRLoss(nc=NC, nq=30, imgsz=IMGSZ, max_boxes=MAXB)
    blocked = JR.build_dn_attn_blocked(jloss.dn_cfg, 30)
    dn = JR.make_cdn_group(jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask),
                           jax.random.PRNGKey(3), nc=NC, imgsz=float(IMGSZ), cfg=jloss.dn_cfg,
                           attn_blocked=jnp.asarray(blocked))

    def loss_fn(params):
        preds, _ = jm.graph.apply({"params": params, "batch_stats": jm.variables["batch_stats"]},
                                  jnp.asarray(img), train=True, dn=dn, mutable=["batch_stats"])
        out = jloss(preds, jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask))
        return out.total, out.components

    (total, comps), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jm.variables["params"])
    model = copy.deepcopy(port).train()
    pdn = {k: torch.from_numpy(np.asarray(v)) for k, v in dn.items()}
    preds = model(torch.from_numpy(img).permute(0, 3, 1, 2), dn=pdn)
    assert preds[0].shape == (2, 2, 222, 4)
    out = PR.RTDETRLoss(nc=NC, nq=30, imgsz=IMGSZ, max_boxes=MAXB)(
        preds, *(torch.from_numpy(a) for a in (cls, boxes, mask)))
    out.total.backward()
    assert abs(out.total.item() - float(total)) <= 1e-5 * abs(float(total))
    np.testing.assert_allclose(out.components.numpy(), np.asarray(comps), rtol=1e-5)
    want = jax_to_port(model, flatten_tree(jax.tree.map(np.asarray, grads)),
                       collections=("params",))
    named = dict(model.named_parameters())
    assert want.keys() == named.keys()
    floor = 1e-6 * max(np.linalg.norm(w) for w in want.values())
    bad = []
    for k, w in want.items():
        g = named[k].grad
        g = np.zeros_like(w) if g is None else g.numpy()
        if np.linalg.norm(g - w) > 1e-4 * max(np.linalg.norm(w), floor):
            bad.append(f"{k}: {np.linalg.norm(g - w):.2e} of {np.linalg.norm(w):.2e}")
    assert not bad, bad


def test_yolo_train_runs_rtdetr_with_denoising(tmp_path):
    """``YOLO.train`` on the tiny RT-DETR: RTDETRLoss with a denoising group
    each step (T = 222 queries), the val loss over the raw tuple, multi_scale
    turned off with a warning, and ``best`` reloaded as an RT-DETR model."""
    yaml_save(tmp_path / "tiny-rtdetr.yaml", TINY)
    data = make_shapes_dataset(tmp_path / "ds", n_train=4, n_val=2, imgsz=IMGSZ, seed=3)
    m = YOLO(str(tmp_path / "tiny-rtdetr.yaml"), device="cpu", imgsz=IMGSZ)
    seen = []
    m.add_callback("on_train_batch_end", lambda tr: seen.append(tr.train_step.generator))
    r = m.train(data=data, epochs=1, batch=2, imgsz=IMGSZ, project=str(tmp_path / "runs"),
                plots=False, multi_scale=True, max_boxes=MAXB, warmup_epochs=0.0)
    tr = m.trainer
    assert type(tr.loss_fn).__name__ == "RTDETRLoss" and tr.dn_fn is not None
    assert tr.args["multi_scale"] is False and len(seen) == 2 and seen[0] is not None
    assert all(np.isfinite(tr.last_epoch_scalars[k]) and tr.last_epoch_scalars[k] > 0
               for k in ("train/box_loss", "val/box_loss", "val/cls_loss"))
    best = YOLO(r["save_dir"] + "/weights/best", device="cpu")
    assert best.model.head_kind == "rtdetr"
    check_task("detect", "x")  # RT-DETR models are 'detect'
    with pytest.raises(ValueError, match="RT-DETR models are 'detect'"):
        check_task("rtdetr", "x")
