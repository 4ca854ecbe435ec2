"""Detection validator: forward -> NMS -> IoU matching -> mAP.

Counterpart of the detect path of ``yolo_ad_refine_tpu/engine/validator.py``
(reference engine/validator.py:106-219, models/yolo/detect/val.py:17-338):
the model's eval forward gives (decoded, feats); the decoded predictions go
through ``non_max_suppression(multi_label=True, max_nms=2048)``, whose
suppression is K4 on the card; the feats give the val losses; detections
and GT are rescaled to each image's native pixels and matched at IoU
0.50:0.95 on the host, where ``DetMetrics`` computes AP. ``task="obb"``
(an OBB model) takes the rotated NMS (K5 on the card), rescales xywhr
predictions and GT with ``scale_rboxes``, matches them by ``probiou_np``
and leaves the confusion matrix alone, as the JAX validator does; its val
loss is ``OBBLoss`` over the eval output's (feats, angle). ``task=
"segment"`` also matches each image's kept rows' masks against its GT
instances by mask IoU at the prototypes' resolution (``ops/masks.py
mask_iou_matrix`` on the model's device, against the batch's index masks)
into the ``(M)`` metrics; ``task="pose"`` matches the kept rows' keypoints
by OKS (``kpt_iou_np``: GT box area x 0.53, COCO's sigmas at 17
keypoints, else 1 / K) into the ``(P)`` metrics; the val losses of both
are the detection loss's over the maps. ``rect`` (detect
only) letterboxes the val
set into ``rect_buckets`` static aspect-ratio buckets (the dataset's
``set_rectangle``), ``save_json`` writes ``predictions.json`` (COCO-style
entries in native pixels) and ``plots`` writes ``confusion_matrix.png``
and ``PR_curve.png``, both into ``save_dir``. ``backend`` (an
``engine/exporter.py`` ``AutoBackend``) runs standalone validation of the
detect task through an exported artifact: a final partial batch is padded
with zeros to the artifact's batch and its outputs cut back, as the JAX
validator does; NMS and the metrics stay here. A YOLOv10 model (v10Detect)
takes no NMS: its selected rows are cut at ``conf`` (``nms_free_rows``,
the JAX validator's branch), and its val loss is ``E2EDetectLoss`` over the
eval output's branch dict. An RT-DETR model takes no NMS either: its
normalised xywh are scaled by imgsz, each query keeps its best class, and
the rows are sorted by score and cut at ``conf`` (``rtdetr_rows``, the JAX
validator's branch); its val loss is ``RTDETRLoss`` over the raw tuple. A
YOLO-World model runs with its text embeddings, and K4's candidates take
its vocabulary's class count (``DetectionModel.n_scores``), where the JAX
validator passes the yaml's nc (ROADMAP Queue 3). A backend reads the head
kind and the score count from the artifact's sidecar
(``DetectionModel.head_kind``, ``n_scores``), so the same branches serve an
exported v10, World or RT-DETR program; a sidecar without them counts as a
plain detect head, and a program whose output width is not 4 + nc then
raises at the first batch. Classification validates through
``train/classify.py`` ``validate``; a backend of any task but detect is
not ported.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.data.build import DataLoader
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset, check_task
from yolo_ad_refine_tpu_torch.ops.boxes import scale_boxes, scale_rboxes
from yolo_ad_refine_tpu_torch.ops.masks import mask_iou_matrix
from yolo_ad_refine_tpu_torch.ops.nms import nms_free_rows, non_max_suppression, rtdetr_rows
from yolo_ad_refine_tpu_torch.train.pose import OKS_SIGMA
from yolo_ad_refine_tpu_torch.train.step import images_to_tensor, targets_to_device
from yolo_ad_refine_tpu_torch.utils import LOGGER, not_ported
from yolo_ad_refine_tpu_torch.utils.metrics import (
    ConfusionMatrix, DetMetrics, box_iou_np, kpt_iou_np, match_predictions, probiou_np)


class DetectionValidator:
    """Runs a model over a val split and computes detection metrics.
    ``args``: imgsz, batch, conf (0.001), iou (0.7), max_det (300),
    max_nms (2048), max_boxes, split, data, task (detect, obb, segment or
    pose), amp
    (bf16 autocast on the card), rect and rect_buckets (4), save_json,
    plots and save_dir (".")."""

    def __init__(self, args: dict | None = None, dataloader: DataLoader | None = None):
        self.args = dict(args or {})
        self.dataloader = dataloader
        self.names = None
        self.jdict = None
        self.task = self.args.get("task") or "detect"
        check_task(self.task, "validate")

    def _build_dataloader(self, data, imgsz: int, batch: int) -> DataLoader:
        info = check_det_dataset(data)
        split = self.args.get("split", "val")
        path = info.get(split) or info.get("val") or info.get("train")
        ds = YOLODataset(path, imgsz=imgsz, augment=False, nc=info["nc"],
                         max_boxes=int(self.args.get("max_boxes", 128)), task=self.task)
        self.names = info["names"]
        plan = None
        if self.args.get("rect") and self.task == "detect":
            # K static aspect-ratio buckets; a batch never straddles two
            plan = ds.set_rectangle(batch, nbuckets=int(self.args.get("rect_buckets") or 4))
        return DataLoader(ds, batch_size=batch, shuffle=False, batch_plan=plan)

    @torch.no_grad()
    def __call__(self, model=None, dataloader=None, loss_fn=None, backend=None) -> dict:
        """model: a port DetectionModel (for example the EMA's). loss_fn:
        a DetectionLoss (an OBBLoss for OBB; for segment and pose the
        detection loss, given the maps) for the val losses.
        ``backend``: an ``AutoBackend`` that runs the forward instead of
        ``model`` (which may then be None: nc and names come from the
        artifact's metadata), detect task only, without val losses (an
        artifact returns the decoded predictions, not the maps)."""
        if backend is not None and (self.task != "detect" or backend.task != "detect"):
            task = self.task if self.task != "detect" else backend.task
            not_ported(f"validating task {task!r} through an exported backend (the "
                       "JAX validator runs the detect task only)",
                       "ROADMAP Queue 1 item 11, export and serving")
        args = self.args
        imgsz = int(args.get("imgsz", 640))
        conf = float(args.get("conf") or 0.001)
        iou = float(args.get("iou", 0.7))
        max_det = int(args.get("max_det", 300))
        max_nms = int(args.get("max_nms", 2048))
        nc = model.n_scores if model is not None else backend.n_scores
        kind = model.head_kind if model is not None else backend.head
        rotated = self.task == "obb"
        if model is not None and model.task != self.task:
            raise ValueError(f"validating task {self.task!r} with a {model.task!r} model")
        if backend is not None:
            loss_fn = None
        dataloader = dataloader or self.dataloader
        if dataloader is None:
            dataloader = self._build_dataloader(args["data"], imgsz, int(args.get("batch", 16)))
        names = (self.names or getattr(model, "names", None)
                 or (backend.names if backend is not None else None)
                 or {i: f"class{i}" for i in range(nc)})
        dev = next(model.parameters()).device if backend is None else backend.device
        amp = bool(args.get("amp")) and dev.type == "cuda"
        if model is not None:
            training = model.training
            model.eval()

        metrics = DetMetrics(names)
        task_metrics = DetMetrics(names) if self.task in ("segment", "pose") else None
        kpt_sigmas = None
        if self.task == "pose":
            k = model.model[model.head_idx].kpt_shape[0]
            kpt_sigmas = OKS_SIGMA if k == 17 else np.ones(k) / k
        confusion = ConfusionMatrix(nc)
        self.jdict = [] if args.get("save_json") else None
        loss_sum = torch.zeros(3, device=dev)
        n_batches = seen = 0
        t_inference = 0.0
        t0 = time.perf_counter()
        for batch in dataloader:
            t1 = time.perf_counter()
            if backend is not None:
                y = self._backend_forward(backend, batch["img"])
                width = 6 if kind == "v10" else 4 + nc
                if seen == 0 and y.shape[-1] != width:
                    raise ValueError(
                        f"{backend.path}: the program gives {y.shape[-1]} columns where its "
                        f"sidecar's {kind!r} head with {nc} scores gives {width}; a sidecar "
                        "without 'head' and 'n_scores' (written before they were recorded) "
                        "counts as a plain detect head: export the model again")
            else:
                img = images_to_tensor(batch["img"], dev)
                with (torch.autocast(dev.type, dtype=torch.bfloat16) if amp
                      else contextlib.nullcontext()):
                    y, feats = model(img)
            if kind == "v10":
                det, cnt, extras = nms_free_rows(y, conf)
            elif kind == "rtdetr":
                det, cnt, extras = rtdetr_rows(y, conf, imgsz)
            else:
                det, cnt, extras = non_max_suppression(
                    y, conf_thres=conf, iou_thres=iou, max_det=max_det, max_nms=max_nms,
                    multi_label=True, nc=nc, rotated=rotated)
            if loss_fn is not None:  # OBBLoss takes (feats, angle); segment, pose the maps
                maps = feats[0] if self.task in ("segment", "pose") else feats
                loss_sum += loss_fn(maps, *targets_to_device(batch, dev)).components
                n_batches += 1
            cnt = cnt.cpu().numpy()
            task_ious = (self._mask_ious(feats[2], extras, det, cnt, batch)
                         if self.task == "segment" else None)
            det = det.cpu().numpy()
            angles = extras[..., 0].cpu().numpy() if rotated else None
            pred_kpts = extras.cpu().numpy() if self.task == "pose" else None
            t_inference += time.perf_counter() - t1
            if self.task == "pose":
                task_ious = self._oks(det, cnt, batch, pred_kpts, model, kpt_sigmas)
            self._update_metrics(det, cnt, batch, metrics, confusion, batch["img"].shape[1:3],
                                 angles, self.jdict, task_metrics, task_ious)
            seen += len(batch["im_file"])
        if model is not None:
            model.train(training)

        results = metrics.process()
        self.metrics, self.confusion_matrix = metrics, confusion
        if task_metrics is not None:
            tag = "M" if self.task == "segment" else "P"
            r = task_metrics.process()
            results[f"metrics/mAP50({tag})"] = r["metrics/mAP50(B)"]
            results[f"metrics/mAP50-95({tag})"] = r["metrics/mAP50-95(B)"]
            self.task_metrics = task_metrics
        if n_batches:
            ls = (loss_sum / n_batches).tolist()
            results.update({"val/box_loss": ls[0], "val/cls_loss": ls[1], "val/dfl_loss": ls[2]})
        results["speed_ms_per_image"] = (time.perf_counter() - t0) / max(seen, 1) * 1000
        results["inference_ms_per_image"] = t_inference / max(seen, 1) * 1000
        r = metrics.results_dict
        LOGGER.info(f"{'all':>10}{seen:>8} P {r['metrics/precision(B)']:.3f} "
                    f"R {r['metrics/recall(B)']:.3f} mAP50 {r['metrics/mAP50(B)']:.3f} "
                    f"mAP50-95 {r['metrics/mAP50-95(B)']:.3f}")
        save_dir = Path(args.get("save_dir") or ".")
        if self.jdict is not None:
            out = save_dir / "predictions.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(self.jdict))
            LOGGER.info(f"save_json: {len(self.jdict)} predictions -> {out}")
        if args.get("plots") and args.get("save_dir"):
            self._plot(metrics, confusion, names, save_dir)
        return results

    @staticmethod
    def _mask_ious(proto, coeffs, det, cnt, batch) -> list[np.ndarray]:
        """Each image's (n_gt, n) mask IoU of its n kept rows against its
        n_gt GT instances (``mask_iou_matrix`` on the rows the JAX validator
        reads of its (max_boxes, max_det) matrix), on the model's device."""
        gt = torch.from_numpy(batch["masks"]).to(proto.device)
        img_hw = tuple(batch["img"].shape[1:3])
        out = []
        for i in range(len(cnt)):
            n, n_gt = int(cnt[i]), int((batch["mask"][i, :, 0] > 0).sum())
            out.append(mask_iou_matrix(proto[i], coeffs[i, :n], det[i, :n, :4], img_hw, gt[i],
                                       n_gt).cpu().numpy())
        return out

    @staticmethod
    def _oks(det, cnt, batch, pred_kpts, model, sigmas) -> list[np.ndarray | None]:
        """Each image's (n_gt, n) OKS of its kept rows' keypoints against its
        GT's, in letterboxed pixels (OKS does not move under the letterbox's
        scale and shift), with the GT box areas x 0.53 (the JAX validator's);
        None where either side is empty."""
        kpt_shape = model.model[model.head_idx].kpt_shape
        out = []
        for i in range(len(cnt)):
            n, m = int(cnt[i]), batch["mask"][i, :, 0] > 0
            if not (n and m.any()):
                out.append(None)
                continue
            gt_boxes = batch["bboxes"][i][m]
            area = np.prod(np.clip(gt_boxes[:, 2:4] - gt_boxes[:, :2], 1, None), -1)
            pk = pred_kpts[i, :n].reshape(n, *kpt_shape)
            out.append(kpt_iou_np(batch["keypoints"][i][m], pk, area * 0.53, np.asarray(sigmas)))
        return out

    @staticmethod
    def _backend_forward(backend, img: np.ndarray) -> torch.Tensor:
        """The artifact's decoded predictions for a host batch (B, H, W, 3):
        an artifact has a fixed input batch, so a final partial batch is
        padded with zero images up to it and the outputs are cut back (the
        JAX validator's standalone mode, its engine/validator.py:142-158)."""
        n = img.shape[0]
        if backend.batch is not None and n < backend.batch:
            img = np.concatenate([img, np.zeros((backend.batch - n, *img.shape[1:]), img.dtype)])
        return backend(img)[:n]

    @staticmethod
    def _plot(metrics: DetMetrics, confusion: ConfusionMatrix, names: dict, save_dir: Path):
        """confusion_matrix.png and, when there is an AP, PR_curve.png: each
        class's precision over the recall grid at IoU 0.5."""
        from yolo_ad_refine_tpu_torch.utils.plotting import plot_confusion_matrix, plot_pr_curve

        save_dir.mkdir(parents=True, exist_ok=True)
        plot_confusion_matrix(confusion.matrix, names, save_dir / "confusion_matrix.png")
        box = metrics.box
        if len(box.all_ap) and getattr(box, "prec_values", None) is not None:
            plot_pr_curve(box.px, box.prec_values, box.all_ap, save_dir / "PR_curve.png", names)

    @staticmethod
    def _update_metrics(det, cnt, batch, metrics: DetMetrics, confusion: ConfusionMatrix,
                        imgsz, angles=None, jdict: list | None = None,
                        task_metrics: DetMetrics | None = None, task_ious=None):
        """Rescale both sides to native pixels (reference _prepare_batch /
        _prepare_pred) and match at the 10 IoU thresholds. With ``angles``
        (B, max_det), OBB: det rows are xywh, GT (n, 5) xywhr, matched by
        probiou; the confusion matrix stays axis-aligned only. ``jdict``
        gathers the save_json entries of the JAX validator (reference
        detect/val.py pred_to_json): image_id the file's stem (an int when
        numeric), category_id, bbox [x1, y1, w, h] in native pixels to 3
        places and score to 5, from the rows as they are (OBB: xywh).
        ``task_metrics`` takes the segment or pose matches, by each image's
        (n_gt, n) mask IoU or OKS in ``task_ious`` (None: no match)."""
        imgsz = tuple(int(v) for v in imgsz)
        rotated = angles is not None

        def native(boxes, i):
            if rotated:
                return scale_rboxes(boxes, batch["ratio_pad"][i])
            return scale_boxes(imgsz, torch.from_numpy(np.ascontiguousarray(boxes)),
                               batch["ori_shape"][i], ratio_pad=batch["ratio_pad"][i]).numpy()

        for i in range(det.shape[0]):
            n = int(cnt[i])
            d = det[i, :n].copy()
            m = batch["mask"][i, :, 0] > 0
            gt_boxes = batch["bboxes"][i][m].copy()
            gt_cls = batch["cls"][i][m, 0]
            pred = np.concatenate([d[:, :4], angles[i, :n, None]], -1) if rotated else d[:, :4]
            if n:
                pred = native(pred, i)
                d[:, :4] = pred[:, :4]
            if len(gt_boxes):
                gt_boxes = native(gt_boxes, i)
            if jdict is not None and n:
                stem = Path(batch["im_file"][i]).stem
                image_id = int(stem) if stem.isnumeric() else stem
                for x1, y1, x2, y2, sc, c in d[:, :6]:
                    jdict.append({"image_id": image_id, "category_id": int(c),
                                  "bbox": [round(float(x1), 3), round(float(y1), 3),
                                           round(float(x2 - x1), 3), round(float(y2 - y1), 3)],
                                  "score": round(float(sc), 5)})
            if n == 0:
                if len(gt_cls):
                    metrics.update_stats(np.zeros((0, 10), bool), np.zeros(0), np.zeros(0), gt_cls)
                    if task_metrics is not None:
                        task_metrics.update_stats(np.zeros((0, 10), bool), np.zeros(0),
                                                  np.zeros(0), gt_cls)
                    if not rotated:
                        confusion.process_batch(None, gt_boxes, gt_cls)
                continue
            iou = probiou_np(gt_boxes, pred) if rotated else box_iou_np(gt_boxes, pred)
            tp = (match_predictions(d[:, 5], gt_cls, iou) if len(gt_cls)
                  else np.zeros((n, 10), bool))
            metrics.update_stats(tp, d[:, 4], d[:, 5], gt_cls)
            if task_metrics is not None:
                ious = task_ious[i]
                tp_t = (match_predictions(d[:, 5], gt_cls, ious)
                        if ious is not None and len(gt_cls) else np.zeros((n, 10), bool))
                task_metrics.update_stats(tp_t, d[:, 4], d[:, 5], gt_cls)
            if not rotated:
                confusion.process_batch(d, gt_boxes, gt_cls)
