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
loss waits for OBB training. ``rect`` (detect only) letterboxes the val
set into ``rect_buckets`` static aspect-ratio buckets (the dataset's
``set_rectangle``), ``save_json`` writes ``predictions.json`` (COCO-style
entries in native pixels) and ``plots`` writes ``confusion_matrix.png``
and ``PR_curve.png``, both into ``save_dir``. Other tasks and exported
backends are not ported.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.data.build import DataLoader
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from yolo_ad_refine_tpu_torch.ops.boxes import scale_boxes, scale_rboxes
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression
from yolo_ad_refine_tpu_torch.train.step import images_to_tensor, targets_to_device
from yolo_ad_refine_tpu_torch.utils import LOGGER, not_ported
from yolo_ad_refine_tpu_torch.utils.metrics import (
    ConfusionMatrix, DetMetrics, box_iou_np, match_predictions, probiou_np)


class DetectionValidator:
    """Runs a model over a val split and computes detection metrics.
    ``args``: imgsz, batch, conf (0.001), iou (0.7), max_det (300),
    max_nms (2048), max_boxes, split, data, task ("detect" or "obb"), amp
    (bf16 autocast on the card), rect and rect_buckets (4), save_json,
    plots and save_dir (".")."""

    def __init__(self, args: dict | None = None, dataloader: DataLoader | None = None):
        self.args = dict(args or {})
        self.dataloader = dataloader
        self.names = None
        self.jdict = None
        self.task = self.args.get("task") or "detect"
        if self.task not in ("detect", "obb"):
            not_ported(f"validating task {self.task!r}",
                       "ROADMAP Queue 1 item 12, the other tasks")

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
        a DetectionLoss for the val losses. ``backend`` (an exported model,
        as the JAX validator takes) is not ported and raises."""
        if backend is not None:
            not_ported("validation through an exported backend",
                       "ROADMAP Queue 1 item 11, export and serving")
        args = self.args
        imgsz = int(args.get("imgsz", 640))
        conf = float(args.get("conf") or 0.001)
        iou = float(args.get("iou", 0.7))
        max_det = int(args.get("max_det", 300))
        max_nms = int(args.get("max_nms", 2048))
        nc = model.nc
        rotated = self.task == "obb"
        if model.task != self.task:
            raise ValueError(f"validating task {self.task!r} with a {model.task!r} model")
        if rotated and loss_fn is not None:
            not_ported("the OBB val loss", "ROADMAP Queue 1 item 12, OBB training")
        dataloader = dataloader or self.dataloader
        if dataloader is None:
            dataloader = self._build_dataloader(args["data"], imgsz, int(args.get("batch", 16)))
        names = self.names or getattr(model, "names", None) or {i: f"class{i}" for i in range(nc)}
        dev = next(model.parameters()).device
        amp = bool(args.get("amp")) and dev.type == "cuda"
        training = model.training
        model.eval()

        metrics = DetMetrics(names)
        confusion = ConfusionMatrix(nc)
        self.jdict = [] if args.get("save_json") else None
        loss_sum = torch.zeros(3, device=dev)
        n_batches = seen = 0
        t_inference = 0.0
        t0 = time.perf_counter()
        for batch in dataloader:
            t1 = time.perf_counter()
            img = images_to_tensor(batch["img"], dev)
            with torch.autocast(dev.type, dtype=torch.bfloat16) if amp else contextlib.nullcontext():
                y, feats = model(img)
            det, cnt, extras = non_max_suppression(
                y, conf_thres=conf, iou_thres=iou, max_det=max_det, max_nms=max_nms,
                multi_label=True, nc=nc, rotated=rotated)
            if loss_fn is not None:
                loss_sum += loss_fn(feats, *targets_to_device(batch, dev)).components
                n_batches += 1
            det, cnt = det.cpu().numpy(), cnt.cpu().numpy()
            angles = extras[..., 0].cpu().numpy() if rotated else None
            t_inference += time.perf_counter() - t1
            self._update_metrics(det, cnt, batch, metrics, confusion, batch["img"].shape[1:3],
                                 angles, self.jdict)
            seen += len(batch["im_file"])
        model.train(training)

        results = metrics.process()
        self.metrics, self.confusion_matrix = metrics, confusion
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
                        imgsz, angles=None, jdict: list | None = None):
        """Rescale both sides to native pixels (reference _prepare_batch /
        _prepare_pred) and match at the 10 IoU thresholds. With ``angles``
        (B, max_det), OBB: det rows are xywh, GT (n, 5) xywhr, matched by
        probiou; the confusion matrix stays axis-aligned only. ``jdict``
        gathers the save_json entries of the JAX validator (reference
        detect/val.py pred_to_json): image_id the file's stem (an int when
        numeric), category_id, bbox [x1, y1, w, h] in native pixels to 3
        places and score to 5, from the rows as they are (OBB: xywh)."""
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
                    if not rotated:
                        confusion.process_batch(None, gt_boxes, gt_cls)
                continue
            iou = probiou_np(gt_boxes, pred) if rotated else box_iou_np(gt_boxes, pred)
            tp = (match_predictions(d[:, 5], gt_cls, iou) if len(gt_cls)
                  else np.zeros((n, 10), bool))
            metrics.update_stats(tp, d[:, 4], d[:, 5], gt_cls)
            if not rotated:
                confusion.process_batch(d, gt_boxes, gt_cls)
