"""The readings a cell's limits are set from: the program's compared numbers
over many seeds, and the control's (the reference one precision below the
configuration's, in the program's place) over the same seeds.

    python3 -m portbench.limits --workload <cell> --seeds 11,12,13 [--control] \
        [--fault half_batch_in_loss] [--seconds 1]

One process: for each seed a short run of the cell (its set-up, a window of
``--seconds``, the check) prints the program's numbers; with ``--control``
the control then takes the program's place on the same inputs and its
numbers are printed beside them; with ``--fault <name>`` the program runs
with that fault planted. A JSON line a seed on stdout, with every number
the check reads, held or not. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace


class ControlServe:
    """The reference in bf16 behind ``YOLO``'s face: ``model`` (whose output's
    first value the harness's hook reads) and ``predict``, which letterboxes,
    runs it, suppresses and rescales with the reference's own steps."""

    def __init__(self, model_dict: dict, device="cuda", imgsz: int = 640, cfg=None):
        import torch

        from portbench.reference.model import build

        self.device, self.imgsz = device, imgsz
        self.net = build(cfg["yaml_path"], cfg["scale"], device=device)
        outer = self

        class Model(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.net = outer.net

            def forward(self, x):
                y, maps = self.net(x.to(torch.bfloat16))
                return y.float(), maps

        self.model = Model()

    def load(self, state):
        import torch

        self.net.load_state_dict(state)
        self.net.to(torch.bfloat16).eval()

    def predict(self, images, conf, iou, max_det, batch, imgsz):
        import torch

        from portbench.reference.postprocess import nms, preprocess, scale_boxes

        with torch.no_grad():
            x, metas = preprocess(images, imgsz, self.device)
            y = self.model(x)[0]
            rows, counts, _ = nms(y, conf, iou, max_det)
        out = []
        for j, ((ratio, pad), im) in enumerate(zip(metas, images)):
            r = rows[j, : int(counts[j])]
            r = torch.cat([scale_boxes(r[:, :4], ratio, pad, im.shape[:2]), r[:, 4:]], -1)
            out.append(SimpleNamespace(boxes=SimpleNamespace(data=r.cpu().numpy())))
        return out


def serve_control(cell, seed: int, seconds: float, device: str):
    from portbench import serve

    cfg = cell["config"]

    def program(model_dict, device, imgsz):
        c = ControlServe(model_dict, device, imgsz, cfg)
        c.model.load_state_dict = c.load  # the harness loads its weights through .model
        return c

    return serve.run(cell, seed, seconds, False, time.perf_counter(), device=device,
                     program=program)["numbers"]


def clean(name: str) -> str:
    return name.replace(".parametrizations", "").replace(".original", "")


def train_control(cell, seed: int, batches: list, nb: int, device: str):
    """The control's three steps on the program's three batches: its
    numbers, as ``train.check`` reads the program's."""
    import torch

    from portbench import train
    from portbench.reference.model import build
    from portbench.reference.precision import to_fp8
    from portbench.reference.train import Trainer
    from portbench.weights import make_state

    cfg, tr = cell["config"], cell["traffic"]
    ctl = build(cfg["yaml_path"], cfg["scale"], device=device)
    ctl.load_state_dict(make_state(cfg, seed, device))
    ctl.checkpointed = True
    to_fp8(ctl)
    t = Trainer(ctl, tr["settings"], nb, tr["batch"], cfg["nc"])
    keep = {"outputs": [], "batches": batches}
    for k, batch in enumerate(batches[:3]):
        keep["outputs"].append(t.step(batch).cpu())
        if k == 0:
            keep["buf1"] = {clean(n): b.detach().cpu() for n, b in t.buf.items()}
    keep["row1"] = t.first_row.cpu()
    keep["maps"] = [[m.cpu() for m in t.first_maps]]
    keep["p3"] = {clean(n): p.detach().cpu() for n, p in ctl.named_parameters()}
    keep["ema3"] = {clean(n): v.cpu() for n, v in t.ema.items()}
    del ctl, t
    torch.cuda.empty_cache() if device == "cuda" else None
    return train.check(cfg, tr, seed, nb, keep, device)


def half_batch_in_loss():
    """Plant a fault in the program: its loss leaves out the second half of
    the batch (a full forward) and takes the mean over the rest, at the full
    batch's scale. Returns the undo."""
    from yolo_ad_refine_tpu_torch.train import loss

    real = loss.DetectionLoss.__call__

    def half(self, feats, gt_labels, gt_bboxes, mask_gt):
        b = feats[0].shape[0]
        h = b // 2
        out = real(self, [f[:h] for f in feats], gt_labels[:h], gt_bboxes[:h], mask_gt[:h])
        return loss.LossOutputs(out.total * b / h, out.components)

    loss.DetectionLoss.__call__ = half
    return lambda: setattr(loss.DetectionLoss, "__call__", real)


FAULTS = {"half_batch_in_loss": half_batch_in_loss}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS), help="planted in the program")
    args = ap.parse_args(argv)

    from portbench import harness, run, train

    harness.fixed_caches()
    c = harness.cell(args.workload)
    harness.require_cards(c["chips"])
    undo = FAULTS[args.fault]() if args.fault else None
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"seed": seed, "fault": args.fault}
        if c["traffic"]["kind"] == "train":
            kept = {}
            real_check = train.check

            def keep_check(cfg, tr, seed_, nb, keep, device):
                kept.update(keep, nb=nb)
                return real_check(cfg, tr, seed_, nb, keep, device)

            train.check = keep_check
            out = run.measure(c, seed, args.seconds, False, time.perf_counter())
            train.check = real_check
            line["program"] = out["numbers"]
            if args.control:
                line["control"] = train_control(c, seed, kept["batches"], kept["nb"], "cuda")
        else:
            out = run.measure(c, seed, args.seconds, False, time.perf_counter())
            line["program"] = out["numbers"]
            if args.control:
                line["control"] = serve_control(c, seed, args.seconds, "cuda")
        line["window"] = out["e2e"]
        print(json.dumps(line), flush=True)
    if undo:
        undo()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
