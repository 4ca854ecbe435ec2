"""Dataset explorer: embedding-based similarity search over a dataset.

Parity surface: reference ultralytics/data/explorer/ (LanceDB-backed
Explorer with similarity queries). LanceDB isn't in this environment, so
embeddings live in a numpy table (.npz) — same user surface:
build a table once, then query similar images by index or image.

Embeddings are the global-average-pooled P5 feature map of the detection
backbone (the head's last input level), L2-normalized.

Counterpart of ``yolo_ad_refine_tpu/data/explorer.py``. ``model`` is the
port's ``DetectionModel``; embeddings run on its device (the card by
default, K1 for the flagship's DCN) in its dtype, NCHW where JAX is NHWC.
The last partial batch is padded with zero images up to ``batch``, as in
JAX: a batch-mixing row (MLCA) reads the padding.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset
from yolo_ad_refine_tpu_torch.utils import LOGGER


class Explorer:
    def __init__(self, data: str | dict | None = None, img_path: str | None = None,
                 model=None, imgsz: int = 256, batch: int = 16):
        from yolo_ad_refine_tpu_torch.data.dataset import check_det_dataset

        self.names: dict = {}
        if img_path is None:
            info = check_det_dataset(data)
            img_path = info.get("train") or info.get("val")
            self.names = info.get("names") or {}
        self.dataset = YOLODataset(img_path, imgsz=imgsz, augment=False)
        self.model = model
        self.imgsz = imgsz
        self.batch = batch
        self.embeddings: np.ndarray | None = None

    @torch.no_grad()
    def _embed(self, x: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> (B, C) L2-normalised embeddings."""
        p = next(self.model.parameters())
        t = torch.from_numpy(x).to(p.device).permute(0, 3, 1, 2)
        t = t.to(p.dtype).div(255.0).contiguous(memory_format=torch.channels_last)
        self.model.eval()
        feats = self.model(t)[1]
        if isinstance(feats, tuple):  # OBB, Segment, Pose: (feats, *extras)
            feats = feats[0]
        emb = feats[-1].mean(dim=(2, 3))  # GAP of the deepest level
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)
        return emb.float().cpu().numpy()

    def create_embeddings_table(self, force: bool = False, cache: str | Path | None = None):
        if cache and Path(cache).exists() and not force:
            self.embeddings = np.load(cache)["emb"]
            return self.embeddings
        if self.model is None:
            raise ValueError("Explorer needs a model to embed with")
        embs = []
        n = len(self.dataset)
        for i in range(0, n, self.batch):
            idxs = list(range(i, min(i + self.batch, n)))
            imgs = [self.dataset.get_sample(j)["img"][..., ::-1] for j in idxs]  # BGR->RGB
            x = np.stack(imgs)
            if len(idxs) < self.batch:  # pad to compiled batch
                x = np.concatenate([x, np.zeros((self.batch - len(idxs), *x.shape[1:]), x.dtype)])
            e = self._embed(x)[: len(idxs)]
            embs.append(e)
        self.embeddings = np.concatenate(embs)
        if cache:
            np.savez_compressed(cache, emb=self.embeddings)
        LOGGER.info(f"embedded {n} images -> {self.embeddings.shape}")
        return self.embeddings

    def get_similar(self, idx: int | None = None, embedding: np.ndarray | None = None,
                    limit: int = 9):
        """Most similar dataset images by cosine similarity."""
        if self.embeddings is None:
            raise RuntimeError("call create_embeddings_table() first")
        q = self.embeddings[idx] if embedding is None else embedding
        sims = self.embeddings @ q
        order = np.argsort(-sims)[:limit]
        return [{"idx": int(i), "im_file": self.dataset.im_files[int(i)],
                 "similarity": float(sims[i])} for i in order]

    # -- SQL surface (reference explorer.py:179-250, 437-460) --------------
    def _sql_connection(self):
        """In-memory sqlite over the dataset's label metadata. The reference
        uses duckdb over a LanceDB arrow table (explorer.py:205); sqlite3 is
        the stdlib equivalent available in this environment. Schema: 'table'
        (id, im_file, labels, n_labels) where labels is a comma-joined list
        of class names — the reference's canonical query pattern
        \"WHERE labels LIKE '%person%'\" works unchanged."""
        import sqlite3

        if getattr(self, "_conn", None) is not None:
            return self._conn
        names = self.names
        conn = sqlite3.connect(":memory:")
        conn.execute('CREATE TABLE "table" '
                     "(id INTEGER, im_file TEXT, labels TEXT, n_labels INTEGER)")
        for i in range(len(self.dataset)):
            cls = np.asarray(self.dataset.labels[i]["cls"]).astype(int).ravel()
            labels = ",".join(str(names.get(int(c), int(c))) for c in cls)
            conn.execute('INSERT INTO "table" VALUES (?, ?, ?, ?)',
                         (i, self.dataset.im_files[i], labels, len(cls)))
        conn.commit()
        self._conn = conn
        return conn

    def sql_query(self, query: str, return_type: str = "records"):
        """SQL over the label table. Accepts a full SELECT or a bare WHERE
        clause (reference explorer.py:211-218). Returns a list of dict rows
        ('records'; pandas/arrow aren't guaranteed in this environment)."""
        if return_type != "records":
            raise ValueError("only return_type='records' is supported offline")
        if not query.startswith(("SELECT", "WHERE")):
            raise ValueError(
                f"Query must start with SELECT or WHERE, found: {query}")
        if query.startswith("WHERE"):
            query = f'SELECT * FROM "table" {query}'
        query = query.replace("FROM 'table'", 'FROM "table"')
        LOGGER.info(f"Running query: {query}")
        conn = self._sql_connection()
        cur = conn.execute(query)
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def plot_sql_query(self, query: str, labels: bool = True, max_imgs: int = 9):
        """Grid image (HWC uint8 RGB) of the query results, or None."""
        import cv2

        rows = self.sql_query(query)
        if not rows:
            LOGGER.info("No results found.")
            return None
        tiles = []
        for r in rows[:max_imgs]:
            im = cv2.imread(str(r["im_file"]))
            if im is None:
                continue
            im = np.ascontiguousarray(
                cv2.resize(im, (self.imgsz, self.imgsz))[..., ::-1])
            if labels and r.get("labels"):
                cv2.putText(im, str(r["labels"])[:40], (4, 16),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
            tiles.append(im)
        if not tiles:
            return None
        side = int(np.ceil(np.sqrt(len(tiles))))
        grid = np.zeros((side * self.imgsz, side * self.imgsz, 3), np.uint8)
        for i, t in enumerate(tiles):
            ry, rx = divmod(i, side)
            grid[ry * self.imgsz:(ry + 1) * self.imgsz,
                 rx * self.imgsz:(rx + 1) * self.imgsz] = t
        return grid

    def ask_ai(self, query: str):
        """Natural-language query -> SQL -> results. The reference prompts an
        OpenAI model for the SQL (explorer/utils.py prompt_sql_query) — no
        LLM egress exists here, so a deterministic pattern parser covers the
        documented example family ('show images with 2 persons and 1 dog');
        unparseable questions raise with guidance to use sql_query."""
        import re

        name_set = {str(v).lower() for v in self.names.values()}
        terms = []
        for count, noun in re.findall(r"(\d+)?\s*([a-zA-Z][a-zA-Z _-]*?)s?\b",
                                      query.lower()):
            noun = noun.strip()
            if noun in name_set:
                terms.append((int(count) if count else None, noun))
        if not terms:
            raise ValueError(
                "could not parse the question into SQL offline (the reference "
                "uses an LLM here); use sql_query(...) directly")
        conds = []
        for count, noun in terms:
            like = f"labels LIKE '%{noun}%'"
            if count is not None:
                # count occurrences: (len - len(replaced)) / len(noun)
                conds.append(
                    f"((LENGTH(labels) - LENGTH(REPLACE(labels, '{noun}', '')))"
                    f" / {len(noun)}) = {count}")
            else:
                conds.append(like)
        sql = f'SELECT * FROM "table" WHERE ' + " AND ".join(conds)
        try:
            return self.sql_query(sql)
        except Exception as e:  # mirror the reference's graceful failure
            LOGGER.error(f"generated query was not valid ({e}); "
                         f"try sql_query(...) directly")
            return None

    def similarity_index(self, top_k: int = 5, threshold: float = 0.9):
        """Per-image list of near-duplicates above a similarity threshold."""
        if self.embeddings is None:
            raise RuntimeError("call create_embeddings_table() first")
        sims = self.embeddings @ self.embeddings.T
        np.fill_diagonal(sims, -1)
        out = []
        for i in range(len(sims)):
            close = np.argsort(-sims[i])[:top_k]
            close = [int(j) for j in close if sims[i, j] >= threshold]
            out.append({"idx": i, "similar": close})
        return out
