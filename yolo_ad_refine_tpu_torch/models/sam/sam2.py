"""SAM2 of the PyTorch port: the net, its build function, and the image and video
predictors.

Counterpart of ``yolo_ad_refine_tpu/models/sam/sam2.py`` (reference
models/sam/modules/sam.py SAM2Model, build.py _build_sam2, predict.py).
The memory bank has the JAX package's fixed layout: ``num_maskmem``
spatial-memory slots (slot 0 the nearest conditioning frame, slots
1..m-1 the previous frames, the most recent last) and ``max_obj_ptrs``
object-pointer slots, each with a validity mask, so slot j always carries
temporal position j. The video predictor keeps the frame -> memory dicts
``cond_frames`` / ``non_cond_frames`` on the host, as the JAX one does,
with the memories themselves left on the model's device.

Entry points run on the card unless ``device="cpu"`` is given. Weights are
drawn from ``seed`` (``model.seeded``); ``utils/jax_weights.py
load_sam_variables`` carries a JAX ``build_sam2`` tree in instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.models.sam.model import seeded
from yolo_ad_refine_tpu_torch.models.sam.modules import MLP, PromptEncoder
from yolo_ad_refine_tpu_torch.models.sam.sam2_modules import (
    FpnNeck,
    Hiera,
    ImageEncoder,
    MemoryAttention,
    MemoryEncoder,
    SAM2MaskDecoder,
    get_1d_sine_pe,
    position_embedding_sine,
)
from yolo_ad_refine_tpu_torch.utils import select_device

NO_OBJ_SCORE = -1024.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class SAM2Net(nn.Module):
    """The SAM2 parameter set with the functional steps of a track step
    (reference sam.py:107-955): ``encode_image``, ``sam_heads``,
    ``encode_memory``, ``condition_features``. Maps are NCHW."""

    def __init__(self, embed_dim: int = 96, stages=(1, 2, 7, 2), num_heads: int = 1,
                 global_att_blocks=(5, 7, 9), window_spec=(8, 4, 14, 7),
                 window_spatial_size=(7, 7), backbone_channel_list=(768, 384, 192, 96),
                 image_size: int = 1024, backbone_stride: int = 16, num_maskmem: int = 7,
                 mem_dim: int = 64, hidden_dim: int = 256, max_obj_ptrs: int = 16,
                 sigmoid_scale_for_mem_enc: float = 20.0,
                 sigmoid_bias_for_mem_enc: float = -10.0):
        super().__init__()
        self.image_size, self.num_maskmem, self.mem_dim = image_size, num_maskmem, mem_dim
        self.hidden_dim, self.max_obj_ptrs = hidden_dim, max_obj_ptrs
        self.sigmoid_scale, self.sigmoid_bias = sigmoid_scale_for_mem_enc, sigmoid_bias_for_mem_enc
        self.image_encoder = ImageEncoder(
            Hiera(embed_dim=embed_dim, num_heads=num_heads, stages=tuple(stages),
                  global_att_blocks=tuple(global_att_blocks),
                  window_pos_embed_bkg_spatial_size=tuple(window_spatial_size),
                  window_spec=tuple(window_spec)),
            FpnNeck(hidden_dim, tuple(backbone_channel_list)), scalp=1)
        self.memory_attention = MemoryAttention(hidden_dim, 4, mem_dim)
        self.memory_encoder = MemoryEncoder(mem_dim, hidden_dim)
        emb = image_size // backbone_stride
        self.sam_prompt_encoder = PromptEncoder(hidden_dim, (emb, emb), (image_size, image_size))
        self.sam_mask_decoder = SAM2MaskDecoder(hidden_dim)
        self.obj_ptr_proj = MLP(hidden_dim, hidden_dim, hidden_dim, 3)
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, hidden_dim))
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(num_maskmem, 1, 1, mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        for p in (self.no_obj_ptr, self.maskmem_tpos_enc, self.no_mem_embed,
                  self.no_mem_pos_enc):
            nn.init.normal_(p, std=0.02)
        # a (0, 1) mask prompt down to SAM-logit scale (reference sam.py:251)
        self.mask_downsample = nn.Conv2d(1, 1, 4, 4)

    def encode_image(self, img):
        """Normalised image (B, 3, S, S) -> (feat_s0, feat_s1, feat), the
        first two through the decoder's conv_s0 / conv_s1 (reference
        forward_image)."""
        feats = self.image_encoder(img)["backbone_fpn"]
        dec = self.sam_mask_decoder
        return dec.conv_s0(feats[0]), dec.conv_s1(feats[1]), feats[2]

    def sam_heads(self, feat, points, labels, high_res_features, multimask_output: bool,
                  mask_prompt=None):
        """feat (B, C, h, w); points (B, P, 2) px, labels (B, P) with -1
        padding. Returns (low-res masks, ious, the best low-res mask, its
        high-res (S x S) upsampling, obj_ptr, object score logits)
        (reference _forward_sam_heads)."""
        b = feat.shape[0]
        sparse, dense = self.sam_prompt_encoder(points=(points, labels), masks=mask_prompt)
        masks, ious, sam_tokens, obj_logits = self.sam_mask_decoder(
            feat, self.sam_prompt_encoder.get_dense_pe(), sparse, dense, multimask_output,
            high_res_features)
        is_obj = obj_logits > 0.0
        masks = torch.where(is_obj[:, :, None, None], masks, torch.full_like(masks, NO_OBJ_SCORE))
        hi = F.interpolate(masks, (self.image_size, self.image_size), mode="bilinear",
                           align_corners=False)
        if masks.shape[1] > 1:  # multimask: the best by iou
            best = ious.argmax(-1)
            bidx = torch.arange(b, device=feat.device)
            low_res, high_res = masks[bidx, best][:, None], hi[bidx, best][:, None]
            sam_token = sam_tokens[bidx, best.clamp(max=sam_tokens.shape[1] - 1)]
        else:
            low_res, high_res = masks, hi
            sam_token = sam_tokens[:, 0]
        lam = is_obj.float()
        obj_ptr = lam * self.obj_ptr_proj(sam_token) + (1 - lam) * self.no_obj_ptr
        return masks, ious, low_res, high_res, obj_ptr, obj_logits

    def encode_memory(self, feat, high_res_masks):
        """feat (B, C, h, w); high-res mask logits (B, 1, S, S) -> (memory
        (B, mem_dim, h, w), its position encoding)."""
        m = torch.sigmoid(high_res_masks) * self.sigmoid_scale + self.sigmoid_bias
        return self.memory_encoder(feat, m, skip_mask_sigmoid=True)

    def condition_features(self, feat, mem_spatial=None, mem_spatial_pos=None, mem_valid=None,
                           obj_ptrs=None, ptr_pos_idx=None, ptr_valid=None,
                           is_init: bool = False):
        """The current features fused with the fixed-slot memory bank.

        feat (B, C, h, w); mem_spatial and mem_spatial_pos (B, M, mem_dim, h,
        w); mem_valid (B, M) bool; obj_ptrs (B, P, C); ptr_pos_idx (B, P)
        temporal distances; ptr_valid (B, P) bool. ``is_init``: an initial
        conditioning frame, which only adds the no-memory embedding.
        """
        b, c, h, w = feat.shape
        curr = feat.flatten(2).transpose(1, 2)
        if is_init:
            return (curr + self.no_mem_embed).transpose(1, 2).reshape(b, c, h, w)
        curr_pos = position_embedding_sine(h, w, c, device=feat.device).to(curr.dtype)
        curr_pos = curr_pos.flatten(1).t()[None].expand(b, -1, -1)
        m, md = self.num_maskmem, self.mem_dim
        mem = mem_spatial.flatten(3).transpose(2, 3).reshape(b, m * h * w, md)
        # slot j holds temporal position j; its embedding is maskmem_tpos_enc[m - j - 1]
        tpos = self.maskmem_tpos_enc.flip(0).reshape(m, 1, md)
        mem_pos = (mem_spatial_pos.flatten(3).transpose(2, 3) + tpos[None]).reshape(b, -1, md)
        k_mask_sp = mem_valid.repeat_interleave(h * w, dim=1)
        # object pointers: C split into C / mem_dim tokens each
        p = obj_ptrs.shape[1]
        splits = c // md
        ptr_tok = obj_ptrs.reshape(b, p * splits, md)
        t_max = max(self.max_obj_ptrs - 1, 1)
        ptr_pe = get_1d_sine_pe(ptr_pos_idx / t_max, md).repeat_interleave(splits, dim=1)
        k_mask_ptr = ptr_valid.repeat_interleave(splits, dim=1)
        memory = torch.cat([mem, ptr_tok.to(mem.dtype)], 1)
        memory_pos = torch.cat([mem_pos, ptr_pe.to(mem.dtype)], 1)
        k_mask = torch.cat([k_mask_sp, k_mask_ptr], 1)
        out = self.memory_attention(curr, memory, curr_pos, memory_pos,
                                    num_obj_ptr_tokens=p * splits, k_mask=k_mask)
        return out.transpose(1, 2).reshape(b, c, h, w)

    def empty_memory(self, feat):
        """An all-invalid memory bank for ``feat``'s batch and grid."""
        b, _, h, w = feat.shape
        m, p, dev = self.num_maskmem, self.max_obj_ptrs, feat.device
        return (torch.zeros((b, m, self.mem_dim, h, w), device=dev),
                torch.zeros((b, m, self.mem_dim, h, w), device=dev),
                torch.zeros((b, m), dtype=torch.bool, device=dev),
                torch.zeros((b, p, self.hidden_dim), device=dev),
                torch.zeros((b, p), device=dev),
                torch.zeros((b, p), dtype=torch.bool, device=dev))


SAM2_CONFIGS = {
    "sam2_t": dict(embed_dim=96, stages=(1, 2, 7, 2), num_heads=1, global_att_blocks=(5, 7, 9),
                   window_spec=(8, 4, 14, 7), window_spatial_size=(7, 7),
                   backbone_channel_list=(768, 384, 192, 96)),
    "sam2_s": dict(embed_dim=96, stages=(1, 2, 11, 2), num_heads=1,
                   global_att_blocks=(7, 10, 13), window_spec=(8, 4, 14, 7),
                   window_spatial_size=(7, 7), backbone_channel_list=(768, 384, 192, 96)),
    "sam2_b": dict(embed_dim=112, stages=(2, 3, 16, 3), num_heads=2,
                   global_att_blocks=(12, 16, 20), window_spec=(8, 4, 14, 7),
                   window_spatial_size=(14, 14), backbone_channel_list=(896, 448, 224, 112)),
    "sam2_l": dict(embed_dim=144, stages=(2, 6, 36, 4), num_heads=2,
                   global_att_blocks=(23, 33, 43), window_spec=(8, 4, 16, 8),
                   window_spatial_size=(7, 7), backbone_channel_list=(1152, 576, 288, 144)),
    # the tests' tiny config: one block a stage at 128 px
    "sam2_test": dict(embed_dim=16, stages=(1, 1, 1, 1), num_heads=1, global_att_blocks=(2,),
                      window_spec=(8, 4, 4, 4), window_spatial_size=(7, 7),
                      backbone_channel_list=(128, 64, 32, 16), image_size=128, num_maskmem=3,
                      max_obj_ptrs=4),
}


def build_sam2(variant: str = "sam2_t", image_size: int | None = None,
               device: str | torch.device = "cuda", seed: int = 0) -> SAM2Net:
    """A SAM2Net of ``variant`` with weights drawn from ``seed``, on
    ``device`` in eval mode."""
    device = select_device(device)
    cfg = dict(SAM2_CONFIGS[variant])
    if image_size is not None:
        cfg["image_size"] = image_size
    model = seeded(lambda: SAM2Net(**cfg), seed)
    return model.to(device).eval()


def normalise(img_rgb01: np.ndarray, device) -> torch.Tensor:
    """(S, S, 3) RGB in [0, 1] -> (1, 3, S, S) ImageNet-normalised on ``device``."""
    x = (img_rgb01 - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).permute(2, 0, 1)[None]


class SAM2Predictor:
    """Prompted image segmentation with SAM2 (reference predict.py, the
    image path); the API of ``model.SAM``."""

    MAX_POINTS = 8

    def __init__(self, variant: str = "sam2_t", image_size: int | None = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.device = select_device(device)
        self.net = build_sam2(variant, image_size, self.device, seed)
        self.img_size = self.net.image_size
        self._feats = None
        self._orig_shape = None
        self._scale = 1.0

    def set_image(self, img_bgr: np.ndarray) -> "SAM2Predictor":
        """Longest side to img_size (cv2's default bilinear), pad bottom /
        right, BGR -> RGB, /255, ImageNet normalisation, encode."""
        import cv2

        h0, w0 = img_bgr.shape[:2]
        self._orig_shape = (h0, w0)
        self._scale = self.img_size / max(h0, w0)
        nh, nw = int(round(h0 * self._scale)), int(round(w0 * self._scale))
        img = cv2.resize(img_bgr, (nw, nh))
        canvas = np.zeros((self.img_size, self.img_size, 3), np.float32)
        canvas[:nh, :nw] = img[..., ::-1] / 255.0
        with torch.inference_mode():
            self._feats = self.net.encode_image(normalise(canvas, self.device))
        return self

    def predict(self, points, labels=None):
        """``points`` [[x, y], ...] in original px. Returns (masks
        (k, H0, W0) bool, iou (k,)) sorted by score."""
        if self._feats is None:
            raise RuntimeError("call set_image first")
        s0, s1, feat = self._feats
        pts = np.asarray(points, np.float32).reshape(1, -1, 2) * self._scale
        lab = (np.ones((1, pts.shape[1]), np.float32) if labels is None
               else np.asarray(labels, np.float32).reshape(1, -1))
        n = pts.shape[1]
        if n > self.MAX_POINTS:
            raise ValueError(f"at most {self.MAX_POINTS} points, got {n}")
        pts = np.pad(pts, ((0, 0), (0, self.MAX_POINTS - n), (0, 0)))
        lab = np.pad(lab, ((0, 0), (0, self.MAX_POINTS - n)), constant_values=-1.0)
        with torch.inference_mode():
            featc = self.net.condition_features(feat, is_init=True)
            masks, ious, *_ = self.net.sam_heads(featc, torch.from_numpy(pts).to(self.device),
                                                 torch.from_numpy(lab).to(self.device),
                                                 (s0, s1), True)
        masks = masks[0].float().cpu().numpy()
        ious = ious[0].float().cpu().numpy()
        order = np.argsort(-ious)
        return self._postprocess(masks[order]), ious[order]

    def _postprocess(self, lowres):
        import cv2

        h0, w0 = self._orig_shape
        nh, nw = int(round(h0 * self._scale)), int(round(w0 * self._scale))
        out = []
        for m in lowres:
            up = cv2.resize(m, (self.img_size, self.img_size))[:nh, :nw]
            out.append(cv2.resize(up, (w0, h0)) > 0)
        return np.stack(out)


class SAM2VideoPredictor:
    """Streaming video object segmentation (reference predict.py
    SAM2VideoPredictor + sam.py track_step): ``add_points`` on a
    conditioning frame, then ``track`` / ``propagate`` frame by frame
    through the fixed-slot memory bank."""

    def __init__(self, variant: str = "sam2_test", image_size: int | None = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.device = select_device(device)
        self.net = build_sam2(variant, image_size, self.device, seed)
        self.img_size = self.net.image_size
        self.reset_state()

    def reset_state(self):
        self.cond_frames = {}      # frame_idx -> memory dict
        self.non_cond_frames = {}
        self.num_frames = 0

    def _frame_feats(self, frame: np.ndarray):
        """A BGR frame squashed to img_size (cv2's default bilinear), RGB,
        /255, ImageNet-normalised and encoded."""
        import cv2

        img = cv2.resize(frame, (self.img_size, self.img_size))
        img = img[..., ::-1].astype(np.float32) / 255.0
        return self.net.encode_image(normalise(img, self.device))

    def _memory(self, feat, hi, obj_ptr) -> dict:
        mem_feat, mem_pos = self.net.encode_memory(feat, hi)
        return {"mem_feat": mem_feat, "mem_pos": mem_pos, "obj_ptr": obj_ptr}

    @torch.inference_mode()
    def add_points(self, frame: np.ndarray, frame_idx: int, points, labels=None) -> np.ndarray:
        """Click prompts on a conditioning frame; returns its mask (S, S)
        bool at the model's resolution."""
        s0, s1, feat = self._frame_feats(frame)
        featc = self.net.condition_features(feat, is_init=True)
        pts = np.asarray(points, np.float32).reshape(1, -1, 2)
        pts = pts * (self.img_size / max(frame.shape[:2]))
        lab = (np.ones((1, pts.shape[1]), np.float32) if labels is None
               else np.asarray(labels, np.float32).reshape(1, -1))
        _, _, _, hi, obj_ptr, _ = self.net.sam_heads(
            featc, torch.from_numpy(pts).to(self.device), torch.from_numpy(lab).to(self.device),
            (s0, s1), True)
        self.cond_frames[frame_idx] = self._memory(feat, hi, obj_ptr)
        self.num_frames = max(self.num_frames, frame_idx + 1)
        return (hi[0, 0] > 0).cpu().numpy()

    @torch.inference_mode()
    def track(self, frame: np.ndarray, frame_idx: int):
        """The object tracked into a new frame through the memory bank.
        Returns (mask (S, S) bool, object score logit)."""
        s0, s1, feat = self._frame_feats(frame)
        net = self.net
        mem_sp, mem_pos, mem_valid, ptrs, ptr_pos, ptr_valid = net.empty_memory(feat)
        # slot 0: the nearest conditioning frame
        if self.cond_frames:
            tc = min(self.cond_frames, key=lambda t: abs(t - frame_idx))
            cf = self.cond_frames[tc]
            mem_sp[:, 0], mem_pos[:, 0], mem_valid[:, 0] = cf["mem_feat"], cf["mem_pos"], True
        # slots 1..m-1: the previous frames, the most recent in the last slot
        m, p = net.num_maskmem, net.max_obj_ptrs
        for t_pos in range(1, m):
            prev = self.non_cond_frames.get(frame_idx - (m - t_pos))
            if prev is not None:
                mem_sp[:, t_pos], mem_pos[:, t_pos] = prev["mem_feat"], prev["mem_pos"]
                mem_valid[:, t_pos] = True
        slot = 0
        for t, out in sorted(self.cond_frames.items()):
            if t <= frame_idx and slot < p:
                ptrs[:, slot], ptr_pos[:, slot], ptr_valid[:, slot] = \
                    out["obj_ptr"], abs(frame_idx - t), True
                slot += 1
        for dt in range(1, p - slot + 1):
            prev = self.non_cond_frames.get(frame_idx - dt)
            if prev is not None and slot < p:
                ptrs[:, slot], ptr_pos[:, slot], ptr_valid[:, slot] = prev["obj_ptr"], dt, True
                slot += 1
        featc = net.condition_features(feat, mem_sp, mem_pos, mem_valid, ptrs, ptr_pos, ptr_valid)
        pts = torch.zeros((1, 1, 2), device=self.device)
        lab = -torch.ones((1, 1), device=self.device)
        _, _, _, hi, obj_ptr, obj_logits = net.sam_heads(featc, pts, lab, (s0, s1), True)
        self.non_cond_frames[frame_idx] = self._memory(feat, hi, obj_ptr)
        self.num_frames = max(self.num_frames, frame_idx + 1)
        return (hi[0, 0] > 0).cpu().numpy(), float(obj_logits[0, 0])

    def propagate(self, frames, start_idx: int = 1):
        """Yield (frame_idx, mask) for frames[start_idx:]."""
        for i in range(start_idx, len(frames)):
            mask, _score = self.track(frames[i], i)
            yield i, mask
