"""The port's dataset explorer (``yolo_ad_refine_tpu_torch/data/explorer.py``)
against the JAX package's, with the same numpy-seeded weights carried into
the port (``load_jax_variables``): a tiny model with a ``C3k2_MLCA`` row,
6 labelled images at batch 4, so the last batch is padded with zero images
and MLCA, which mixes the batch, reads the padding.

The weights: kernels N(0, 1/fan_in) with biases and BatchNorm means 0 and
variances 1, so that the head's outputs, whose mean is the embedding,
follow the image rather than the biases (with seeded biases every cosine
is 1 - 1e-6); and MLCA's global kernel x100, so that the padding moves the
last batch's embeddings by 1e-4, ten times the hold's tolerance.

Held: embeddings within 1e-5 of JAX's, the same ``get_similar`` order
(swaps allowed only between similarities within 1e-6), the same
``similarity_index``, and the same SQL rows, ``ask_ai`` rows and
``plot_sql_query`` grid.
"""

import cv2
import numpy as np
import pytest
import torch

from test_torch_weights import randomize
from yolo_ad_refine_tpu.data.explorer import Explorer as JaxExplorer
from yolo_ad_refine_tpu.models.model import build_detection_model as jax_build
from yolo_ad_refine_tpu_torch.data.explorer import Explorer
from yolo_ad_refine_tpu_torch.models.model import build_detection_model
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

TINY = {
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "C3k2_MLCA", [16, False]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]],
    "head": [[[3, 4, 5], 1, "Detect", ["nc"]]],
}
LAYOUTS = [[0, 0, 1], [0], [1, 2], [2, 2], [], [1]]  # 0 person, 1 dog, 2 car


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """6 images of several shapes with labels: noise, the first 3 red-ish
    and the last 3 blue-ish."""
    root = tmp_path_factory.mktemp("explorer")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i, (classes, (h, w)) in enumerate(zip(LAYOUTS, [(64, 64), (80, 60), (64, 96),
                                                        (50, 70), (64, 64), (90, 40)])):
        img = rng.integers(0, 128, (h, w, 3), dtype=np.uint8)
        img[..., 0 if i < 3 else 2] += 127
        cv2.imwrite(str(root / "images" / f"{i}.jpg"), img)
        lines = [f"{c} 0.{3 + 2 * j} 0.5 0.2 0.2" for j, c in enumerate(classes)]
        (root / "labels" / f"{i}.txt").write_text("\n".join(lines))
    (root / "data.yaml").write_text(
        f"path: {root}\ntrain: images\nval: images\nnc: 3\n"
        "names:\n  0: person\n  1: dog\n  2: car\n")
    return root / "data.yaml"


@pytest.fixture(scope="module")
def explorers(data):
    """(JAX explorer, port explorer), both with embeddings built."""
    jm = jax_build(TINY, imgsz=64)
    v = randomize(jm.variables, seed=5)

    def unbias(tree):
        for k, a in tree.items():
            if isinstance(a, dict):
                unbias(a)
            elif k in ("bias", "mean", "var"):
                a[...] = 1.0 if k == "var" else 0.0

    unbias(v["params"])
    unbias(v["batch_stats"])
    v["params"]["modules_2"]["m0"]["attention"]["conv"]["kernel"] *= 100.0
    jm.variables = v
    pm = build_detection_model(TINY, device="cpu", imgsz=64)
    load_jax_variables(pm, flatten_tree(jm.variables["params"]),
                       flatten_tree(jm.variables["batch_stats"]))
    jx = JaxExplorer(data=str(data), model=jm, imgsz=64, batch=4)
    px = Explorer(data=str(data), model=pm, imgsz=64, batch=4)
    jx.create_embeddings_table()
    px.create_embeddings_table()
    return jx, px


def test_embeddings_equal_jax(explorers):
    jx, px = explorers
    assert px.embeddings.shape == jx.embeddings.shape == (6, 64 + 3)
    np.testing.assert_allclose(px.embeddings, jx.embeddings, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(px.embeddings, axis=1), 1.0, atol=1e-5)


def test_the_padded_batch_matters(explorers):
    """MLCA mixes the batch: the last two images embedded alone (padded
    with two zero images) differ from the same images in a full batch."""
    _, px = explorers
    imgs = np.stack([px.dataset.get_sample(j)["img"][..., ::-1] for j in (4, 5, 0, 1)])
    full = px._embed(imgs)[:2]
    assert np.abs(full - px.embeddings[4:6]).max() > 1e-4


def test_the_last_batch_is_padded_with_zero_images(explorers, monkeypatch):
    _, px = explorers
    seen = []
    embed = px._embed
    monkeypatch.setattr(px, "_embed", lambda x: seen.append(x.copy()) or embed(x))
    px.create_embeddings_table(force=True)
    assert [x.shape for x in seen] == [(4, 64, 64, 3)] * 2
    assert not seen[1][2:].any() and seen[1][:2].any()


@pytest.mark.parametrize("idx", range(6))
def test_get_similar_order_equals_jax(explorers, idx):
    jx, px = explorers
    got, want = px.get_similar(idx, limit=6), jx.get_similar(idx, limit=6)
    ws = {r["idx"]: r["similarity"] for r in want}
    assert sorted(ws) == sorted(r["idx"] for r in got)
    for r in got:
        assert abs(r["similarity"] - ws[r["idx"]]) <= 1e-5
    for a, b in zip(got, got[1:]):  # descending in JAX's similarities, ties within 1e-6
        assert ws[a["idx"]] >= ws[b["idx"]] - 1e-6
    assert got[0]["idx"] == want[0]["idx"] == idx


def test_similarity_index_equals_jax(explorers):
    jx, px = explorers
    for th in (0.5, 0.99):
        assert px.similarity_index(top_k=3, threshold=th) == \
            jx.similarity_index(top_k=3, threshold=th)


@pytest.mark.parametrize("query", [
    "SELECT * FROM 'table' WHERE labels LIKE '%person%'", "WHERE n_labels = 2",
    "WHERE labels LIKE '%0%'", "SELECT id, n_labels FROM \"table\" ORDER BY n_labels DESC, id"])
def test_sql_query_equals_jax(explorers, query):
    jx, px = explorers
    assert px.sql_query(query) == jx.sql_query(query)


def test_sql_query_refuses_what_jax_refuses(explorers):
    jx, px = explorers
    for ex in (jx, px):
        with pytest.raises(ValueError):
            ex.sql_query("DROP TABLE 'table'")


@pytest.mark.parametrize("question", ["show images with 2 persons and 1 dog", "images with a car",
                                      "1 dog"])
def test_ask_ai_equals_jax(explorers, question):
    jx, px = explorers
    assert px.ask_ai(question) == jx.ask_ai(question)


def test_ask_ai_refuses_what_jax_refuses(explorers):
    jx, px = explorers
    for ex in (jx, px):
        with pytest.raises(ValueError):
            ex.ask_ai("what is the meaning of life")


@pytest.mark.parametrize("query", ["WHERE labels LIKE '%dog%'", "WHERE n_labels = 7"])
def test_plot_sql_query_equals_jax(explorers, query):
    jx, px = explorers
    got, want = px.plot_sql_query(query), jx.plot_sql_query(query)
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got, want)


def test_embeddings_cache_round_trip(explorers, data, tmp_path):
    _, px = explorers
    cache = tmp_path / "emb.npz"
    ex = Explorer(data=str(data), model=px.model, imgsz=64, batch=4)
    first = ex.create_embeddings_table(cache=cache)
    again = Explorer(data=str(data), model=None, imgsz=64).create_embeddings_table(cache=cache)
    np.testing.assert_array_equal(first, again)
