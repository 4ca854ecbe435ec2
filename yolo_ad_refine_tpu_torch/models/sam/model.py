"""SAM model, its build function and facade of the PyTorch port, with automatic mask
generation.

Counterpart of ``yolo_ad_refine_tpu/models/sam/model.py`` (reference
models/sam/ build.py, modules/sam.py SAMModel, model.py, predict.py,
amg.py). ``SAM(variant).set_image(img_bgr).predict(points=...)`` runs on
the card unless ``device="cpu"`` is given, and raises where CUDA is
absent. Prompts are padded to ``MAX_POINTS`` point slots (label -1), as in
the JAX facade; the host-side resizes (cv2) and the mask generator's
stability score and NMS are the JAX facade's, value for value.

Weights are drawn from ``seed``: the reference's init, and the tensors the
reference starts at zero (the relative-position tables, the position
embedding, TinyViT's attention biases) from N(0, 0.02^2), so a seeded model
runs every path. ``utils/jax_weights.py load_sam_variables`` carries a JAX
``build_sam`` tree in instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from yolo_ad_refine_tpu_torch.models.sam.modules import ImageEncoderViT, MaskDecoder, PromptEncoder
from yolo_ad_refine_tpu_torch.utils import select_device

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
ZERO_INIT = ("rel_pos_h", "rel_pos_w", "pos_embed", "pos_embed_window", "attention_biases")


class SAMModel(nn.Module):
    """Image encoder + prompt encoder + mask decoder (reference modules/sam.py).
    ``forward(image (B, 3, S, S) RGB 0-255)`` -> embeddings (B, 256, S/16,
    S/16); ``decode(embeddings, points, boxes, masks, multimask_output)`` ->
    (masks, iou_pred)."""

    def __init__(self, img_size: int = 1024, encoder_type: str = "vit",
                 encoder_embed_dim: int = 768, encoder_depth: int = 12,
                 encoder_num_heads: int = 12, encoder_global_attn_indexes=(2, 5, 8, 11),
                 prompt_embed_dim: int = 256):
        super().__init__()
        g = img_size // 16
        if encoder_type == "tiny":
            from yolo_ad_refine_tpu_torch.models.sam.tiny_encoder import TinyViT

            self.image_encoder = TinyViT(img_size=img_size)
        else:
            self.image_encoder = ImageEncoderViT(
                img_size=img_size, embed_dim=encoder_embed_dim, depth=encoder_depth,
                num_heads=encoder_num_heads, global_attn_indexes=tuple(encoder_global_attn_indexes),
                out_chans=prompt_embed_dim)
        self.prompt_encoder = PromptEncoder(prompt_embed_dim, (g, g), (img_size, img_size))
        self.mask_decoder = MaskDecoder(prompt_embed_dim)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN).view(-1, 1, 1), False)
        self.register_buffer("pixel_std", torch.tensor(PIXEL_STD).view(-1, 1, 1), False)
        self.img_size = img_size

    def forward(self, image):
        return self.image_encoder((image.float() - self.pixel_mean) / self.pixel_std)

    def decode(self, embeddings, points=None, boxes=None, masks=None,
               multimask_output: bool = True):
        sparse, dense = self.prompt_encoder(points=points, boxes=boxes, masks=masks)
        return self.mask_decoder(embeddings, self.prompt_encoder.get_dense_pe(), sparse, dense,
                                 multimask_output)


SAM_VARIANTS = {
    # reference build.py:23-54
    "sam_b": dict(encoder_embed_dim=768, encoder_depth=12, encoder_num_heads=12,
                  encoder_global_attn_indexes=(2, 5, 8, 11)),
    "sam_l": dict(encoder_embed_dim=1024, encoder_depth=24, encoder_num_heads=16,
                  encoder_global_attn_indexes=(5, 11, 17, 23)),
    "sam_h": dict(encoder_embed_dim=1280, encoder_depth=32, encoder_num_heads=16,
                  encoder_global_attn_indexes=(7, 15, 23, 31)),
    # mobile_sam (reference build.py:56-66, TinyViT trunk)
    "mobile_sam": dict(encoder_type="tiny"),
    # the tests' tiny config (not a reference variant)
    "sam_test": dict(encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2,
                     encoder_global_attn_indexes=(1,)),
}


def seeded(build, seed: int) -> nn.Module:
    """``build()`` under a forked RNG seeded with ``seed`` (on the CPU, so
    the weights do not depend on the device), with the ``ZERO_INIT``
    tensors drawn from N(0, 0.02^2)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.rsplit(".", 1)[-1] in ZERO_INIT:
                    p.normal_(0.0, 0.02)
    return model


def build_sam(variant: str = "sam_b", img_size: int = 1024, device: str | torch.device = "cuda",
              seed: int = 0) -> SAMModel:
    """A SAMModel of ``variant`` at ``img_size`` with weights drawn from
    ``seed``, on ``device`` in eval mode."""
    device = select_device(device)
    cfg = SAM_VARIANTS[variant]
    model = seeded(lambda: SAMModel(img_size=img_size, **cfg), seed)
    return model.to(device).eval()


class SAM:
    """Prompted segmentation on one image (reference model.py SAM +
    predict.py Predictor).

    >>> sam = SAM("sam_b", img_size=1024)          # on the card
    >>> masks, scores = sam.set_image(img_bgr).predict(points=[[320, 240]], labels=[1])
    """

    MAX_POINTS = 8  # fixed prompt slots, padded with label -1

    def __init__(self, variant: str = "sam_b", img_size: int = 1024,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.variant, self.img_size = variant, img_size
        self.device = select_device(device)
        self.model = build_sam(variant, img_size, self.device, seed)
        self._embeddings = None
        self._last_lowres = None
        self._orig_shape = None
        self._scale = 1.0

    def set_image(self, img_bgr: np.ndarray) -> "SAM":
        """Longest side to img_size (cv2 bilinear on the host), pad bottom /
        right, BGR -> RGB, encode on the model's device."""
        import cv2

        h0, w0 = img_bgr.shape[:2]
        self._orig_shape = (h0, w0)
        self._scale = self.img_size / max(h0, w0)
        nh, nw = int(round(h0 * self._scale)), int(round(w0 * self._scale))
        img = cv2.resize(img_bgr, (nw, nh), interpolation=cv2.INTER_LINEAR)
        canvas = np.zeros((self.img_size, self.img_size, 3), np.uint8)
        canvas[:nh, :nw] = img[..., ::-1]  # BGR -> RGB
        x = torch.from_numpy(canvas).to(self.device).permute(2, 0, 1)[None]
        with torch.inference_mode():
            self._embeddings = self.model(x)
        return self

    def _decode(self, points=None, labels=None, box=None, multimask_output: bool = True):
        """Low-res logits (k, 4g, 4g) and iou (k,) of one prompt, on the host."""
        dev = self.device
        with torch.inference_mode():
            if box is not None:
                b = np.asarray(box, np.float32).reshape(1, 2, 2) * self._scale
                masks, iou = self.model.decode(self._embeddings, boxes=torch.from_numpy(b).to(dev),
                                               multimask_output=multimask_output)
            else:
                pts = np.asarray(points, np.float32).reshape(1, -1, 2) * self._scale
                lab = (np.ones((1, pts.shape[1]), np.float32) if labels is None
                       else np.asarray(labels, np.float32).reshape(1, -1))
                n = pts.shape[1]
                if n > self.MAX_POINTS:
                    raise ValueError(f"at most {self.MAX_POINTS} points, got {n}")
                pts = np.pad(pts, ((0, 0), (0, self.MAX_POINTS - n), (0, 0)))
                lab = np.pad(lab, ((0, 0), (0, self.MAX_POINTS - n)), constant_values=-1.0)
                masks, iou = self.model.decode(
                    self._embeddings, points=(torch.from_numpy(pts).to(dev),
                                              torch.from_numpy(lab).to(dev)),
                    multimask_output=multimask_output)
        return masks[0].float().cpu().numpy(), iou[0].float().cpu().numpy()

    def predict(self, points=None, labels=None, box=None, multimask_output: bool = True):
        """Masks of a point prompt (``points`` [[x, y], ...] in original px,
        ``labels`` 1 foreground / 0 background) or of a ``box`` [x1, y1, x2,
        y2]. Returns (masks (k, H0, W0) bool, iou (k,)) sorted by score."""
        if self._embeddings is None:
            raise RuntimeError("call set_image first")
        masks, iou = self._decode(points, labels, box, multimask_output)
        order = np.argsort(-iou)
        # the low-res logits in the order of the returned masks, for generate()
        self._last_lowres = masks[order]
        return self._postprocess(masks[order]), iou[order]

    def _postprocess(self, lowres_masks: np.ndarray) -> np.ndarray:
        """Low-res logits -> boolean masks at the original size: up to
        img_size, the pad stripped, down to the original, threshold 0 (cv2
        bilinear on the host, as the JAX facade)."""
        import cv2

        h0, w0 = self._orig_shape
        nh, nw = int(round(h0 * self._scale)), int(round(w0 * self._scale))
        out = []
        for m in lowres_masks:
            up = cv2.resize(m, (self.img_size, self.img_size),
                            interpolation=cv2.INTER_LINEAR)[:nh, :nw]
            out.append(cv2.resize(up, (w0, h0), interpolation=cv2.INTER_LINEAR) > 0)
        return np.stack(out)

    def generate(self, img_bgr: np.ndarray, points_per_side: int = 8,
                 pred_iou_thresh: float = 0.6, stability_score_thresh: float = 0.7,
                 stability_offset: float = 1.0, nms_iou: float = 0.7) -> list[dict]:
        """Automatic masks: a point grid, each point decoded with three
        masks, kept on predicted IoU and stability (the low-res logits'
        areas over +/- ``stability_offset``), then box NMS. Returns dicts of
        'segmentation', 'bbox', 'predicted_iou', 'stability_score'."""
        self.set_image(img_bgr)
        h0, w0 = self._orig_shape
        step_x, step_y = w0 / points_per_side, h0 / points_per_side
        cands = []
        for iy in range(points_per_side):
            for ix in range(points_per_side):
                px, py = (ix + 0.5) * step_x, (iy + 0.5) * step_y
                masks, iou = self.predict(points=[[px, py]], multimask_output=True)
                for m_bool, score, logits in zip(masks, iou, self._last_lowres):
                    if score < pred_iou_thresh:
                        continue
                    hi = logits > stability_offset
                    lo = logits > -stability_offset
                    stability = hi.sum() / max(lo.sum(), 1)
                    if stability < stability_score_thresh or not m_bool.any():
                        continue
                    ys, xs = np.nonzero(m_bool)
                    bbox = [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]
                    cands.append({"segmentation": m_bool, "bbox": bbox,
                                  "predicted_iou": float(score),
                                  "stability_score": float(stability)})
        return self._nms(cands, nms_iou)

    @staticmethod
    def _nms(cands: list, iou_thres: float) -> list:
        """Greedy NMS of the candidates' boxes, by predicted IoU."""
        cands = sorted(cands, key=lambda c: -c["predicted_iou"])
        kept = []
        for c in cands:
            x1, y1, x2, y2 = c["bbox"]
            a = max(0, x2 - x1) * max(0, y2 - y1)
            ok = True
            for k in kept:
                kx1, ky1, kx2, ky2 = k["bbox"]
                iw = max(0, min(x2, kx2) - max(x1, kx1))
                ih = max(0, min(y2, ky2) - max(y1, ky1))
                inter = iw * ih
                ka = max(0, kx2 - kx1) * max(0, ky2 - ky1)
                if inter / max(a + ka - inter, 1e-9) > iou_thres:
                    ok = False
                    break
            if ok:
                kept.append(c)
        return kept
