"""Callback hooks of the trainer, and the integrations its settings switch on.

Counterpart of ``yolo_ad_refine_tpu/utils/callbacks.py`` (reference
utils/callbacks/base.py:10-199 and the integration callbacks): the hook
names, a per-object registry, and ``integration_callbacks(save_dir)``,
which the detection trainer adds to every training on the rank that writes
the run (JAX train/trainer.py:121-125), gated by the settings file
(``utils/settings.py``):

- ``jsonl`` (on by default): ``JsonlTracker`` writes
  ``<save_dir>/metrics.jsonl``, one JSON line at the start, one an epoch
  and one at the end, as the JAX tracker does;
- ``tensorboard``: the epoch scalars as an event file in ``save_dir``,
  written with the tensorboard package's records (the JAX package writes
  them through ``tf.summary``);
- ``mlflow`` (a local ``mlruns`` store under ``save_dir``) and the SDK
  trackers ``wandb``, ``comet``, ``clearml``, ``dvc`` and ``neptune``.

An integration whose package is not installed is skipped with a log line,
where the JAX package skips it silently.
"""

from __future__ import annotations

import importlib.util
import json
from collections import defaultdict
from pathlib import Path

from yolo_ad_refine_tpu_torch.utils import LOGGER

PROJECT = "yolo_ad_refine_tpu_torch"

HOOKS = (
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor and exporter: registered as in the JAX package, which runs none of them
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    "on_export_start", "on_export_end",
)


def get_default_callbacks() -> dict:
    """An empty callback list for each hook."""
    return defaultdict(list, {h: [] for h in HOOKS})


class Callbacks:
    """Per-object callback registry; a failing callback is logged, not raised."""

    def __init__(self):
        self._callbacks: dict[str, list] = get_default_callbacks()

    def add(self, event: str, callback):
        if event not in self._callbacks:
            raise KeyError(f"unknown hook {event!r}")
        self._callbacks[event].append(callback)

    def copy(self) -> "Callbacks":
        """A registry holding the same callbacks, to which a run adds its own."""
        out = Callbacks()
        for event, fns in self._callbacks.items():
            out._callbacks[event] = list(fns)
        return out

    def run(self, event: str, *args, **kwargs):
        for cb in self._callbacks.get(event, []):
            try:
                cb(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - a callback must not end training
                LOGGER.warning(f"callback {getattr(cb, '__name__', cb)} for {event} failed: {e}")


def _installed(name: str, module: str) -> bool:
    if importlib.util.find_spec(module) is not None:
        return True
    LOGGER.info(f"integration {name}: the {module} package is not installed; skipped")
    return False


def tensorboard_callbacks(log_dir) -> dict:
    """{hook: fn} writing each epoch's scalars to a TensorBoard event file
    in ``log_dir`` (``events.out.tfevents.<time>.<host>.<pid>``, made at
    the first epoch's end), or {} without the tensorboard package. The
    records are the tensorboard package's protobufs in its own
    ``RecordWriter``: ``torch.utils.tensorboard`` would import TensorFlow
    wherever it is installed, ~12 s in each process that trains."""
    if not _installed("tensorboard", "tensorboard"):
        return {}
    import os
    import socket
    import time

    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.proto.summary_pb2 import Summary
    from tensorboard.summary.writer.record_writer import RecordWriter

    path = Path(log_dir) / (f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
                            f".{os.getpid()}")
    state: dict = {}

    def on_fit_epoch_end(trainer):
        if "writer" not in state:
            state["file"] = open(path, "wb")  # noqa: SIM115 - closed at on_train_end
            state["writer"] = RecordWriter(state["file"])
            state["writer"].write(Event(wall_time=time.time(),
                                        file_version="brain.Event:2").SerializeToString())
        values = [Summary.Value(tag=k, simple_value=float(v))
                  for k, v in getattr(trainer, "last_epoch_scalars", {}).items()]
        state["writer"].write(Event(wall_time=time.time(), step=int(trainer.current_epoch),
                                    summary=Summary(value=values)).SerializeToString())
        state["writer"].flush()

    def on_train_end(trainer):
        if "file" in state:
            state["file"].close()

    return {"on_fit_epoch_end": on_fit_epoch_end, "on_train_end": on_train_end}


def mlflow_callbacks(save_dir, run_name: str = "train") -> dict:
    """{hook: fn} logging the run's parameters and metrics to a local
    ``mlruns`` store under ``save_dir``, or {} without mlflow."""
    if not _installed("mlflow", "mlflow"):
        return {}
    import mlflow

    uri = f"file://{Path(save_dir).resolve() / 'mlruns'}"

    def on_train_start(trainer):
        mlflow.set_tracking_uri(uri)
        mlflow.set_experiment(PROJECT)
        mlflow.start_run(run_name=run_name)
        mlflow.log_params({k: str(v) for k, v in trainer.args.items()
                           if isinstance(v, (int, float, str, bool))})

    def on_fit_epoch_end(trainer):
        mlflow.log_metrics({k.replace("(", "").replace(")", ""): float(v)
                            for k, v in getattr(trainer, "last_epoch_scalars", {}).items()},
                           step=int(trainer.current_epoch))

    def on_train_end(trainer):
        for f in ("results.csv", "args.yaml"):
            p = Path(trainer.save_dir) / f
            if p.exists():
                mlflow.log_artifact(str(p))
        mlflow.end_run()

    return {"on_train_start": on_train_start, "on_fit_epoch_end": on_fit_epoch_end,
            "on_train_end": on_train_end}


class _TrackerAdapter:
    """The start(params) / log(metrics, step) / finish(artifacts) protocol
    every experiment tracker implements, wired to the trainer's hooks."""

    def callbacks(self, save_dir) -> dict:
        def on_train_start(trainer):
            self.start({k: v for k, v in trainer.args.items()
                        if isinstance(v, (int, float, str, bool))}, save_dir)

        def on_fit_epoch_end(trainer):
            self.log(dict(getattr(trainer, "last_epoch_scalars", {})), int(trainer.current_epoch))

        def on_train_end(trainer):
            self.finish([p for f in ("results.csv", "args.yaml", "results.png")
                         if (p := Path(trainer.save_dir) / f).exists()])

        return {"on_train_start": on_train_start, "on_fit_epoch_end": on_fit_epoch_end,
                "on_train_end": on_train_end}


class JsonlTracker(_TrackerAdapter):
    """The offline tracker: one JSON line at the start, one an epoch, one at
    the end, in ``<save_dir>/metrics.jsonl``."""

    def start(self, params, save_dir):
        self.path = Path(save_dir) / "metrics.jsonl"
        self.path.write_text(json.dumps({"event": "start", "params": params}) + "\n")

    def log(self, metrics, step):
        with self.path.open("a") as f:
            f.write(json.dumps({"event": "epoch", "step": step,
                                "metrics": {k: float(v) for k, v in metrics.items()}}) + "\n")

    def finish(self, artifacts):
        with self.path.open("a") as f:
            f.write(json.dumps({"event": "end", "artifacts": [str(a) for a in artifacts]}) + "\n")


class WandbTracker(_TrackerAdapter):
    """Weights & Biases (reference callbacks/wb.py)."""

    def start(self, params, save_dir):
        import wandb

        self.run = wandb.init(project=PROJECT, config=params, dir=str(save_dir))

    def log(self, metrics, step):
        self.run.log(metrics, step=step)

    def finish(self, artifacts):
        for a in artifacts:
            self.run.save(str(a))
        self.run.finish()


class CometTracker(_TrackerAdapter):
    """Comet ML (reference callbacks/comet.py)."""

    def start(self, params, save_dir):
        import comet_ml

        self.exp = comet_ml.Experiment(project_name=PROJECT)
        self.exp.log_parameters(params)

    def log(self, metrics, step):
        self.exp.log_metrics(metrics, step=step)

    def finish(self, artifacts):
        for a in artifacts:
            self.exp.log_asset(str(a))
        self.exp.end()


class ClearmlTracker(_TrackerAdapter):
    """ClearML (reference callbacks/clearml.py)."""

    def start(self, params, save_dir):
        from clearml import Task

        self.task = Task.init(project_name=PROJECT, task_name="train")
        self.task.connect(params)

    def log(self, metrics, step):
        logger = self.task.get_logger()
        for k, v in metrics.items():
            logger.report_scalar("train", k, float(v), iteration=step)

    def finish(self, artifacts):
        for a in artifacts:
            self.task.upload_artifact(name=a.name, artifact_object=str(a))


class DvcTracker(_TrackerAdapter):
    """DVCLive (reference callbacks/dvc.py)."""

    def start(self, params, save_dir):
        from dvclive import Live

        self.live = Live(str(save_dir), save_dvc_exp=True)
        for k, v in params.items():
            self.live.log_param(k, v)

    def log(self, metrics, step):
        for k, v in metrics.items():
            self.live.log_metric(k, float(v))
        self.live.next_step()

    def finish(self, artifacts):
        for a in artifacts:
            self.live.log_artifact(str(a))
        self.live.end()


class NeptuneTracker(_TrackerAdapter):
    """Neptune (reference callbacks/neptune.py)."""

    def start(self, params, save_dir):
        import neptune

        self.run = neptune.init_run(project=PROJECT)
        self.run["parameters"] = params

    def log(self, metrics, step):
        for k, v in metrics.items():
            self.run[f"train/{k}"].append(float(v), step=step)

    def finish(self, artifacts):
        for a in artifacts:
            self.run[f"artifacts/{a.name}"].upload(str(a))
        self.run.stop()


TRACKERS = {
    "jsonl": (JsonlTracker, None),  # needs no package
    "wandb": (WandbTracker, "wandb"),
    "comet": (CometTracker, "comet_ml"),
    "clearml": (ClearmlTracker, "clearml"),
    "dvc": (DvcTracker, "dvclive"),
    "neptune": (NeptuneTracker, "neptune"),
}


def tracker_callbacks(name: str, save_dir) -> dict:
    """{hook: fn} of one tracker, {} when its package is not installed."""
    cls, module = TRACKERS[name]
    if module is not None and not _installed(name, module):
        return {}
    return cls().callbacks(save_dir)


def integration_callbacks(save_dir) -> dict:
    """{hook: [fn, ...]} of the integrations the settings switch on
    (reference callbacks/base.py:187 add_integration_callbacks)."""
    from yolo_ad_refine_tpu_torch.utils.settings import get_settings

    s = get_settings()
    sources = []
    if s.get("tensorboard", True):
        sources.append(tensorboard_callbacks(save_dir))
    if s.get("mlflow", False):
        sources.append(mlflow_callbacks(save_dir))
    for name in TRACKERS:
        if s.get(name, name == "jsonl"):  # the offline tracker is on by default
            sources.append(tracker_callbacks(name, save_dir))
    hooks: dict = {}
    for src in sources:
        for hook, fn in src.items():
            hooks.setdefault(hook, []).append(fn)
    return hooks
