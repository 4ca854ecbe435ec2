"""Callback hooks of the trainer.

Counterpart of the registry in ``yolo_ad_refine_tpu/utils/callbacks.py``
(reference utils/callbacks/base.py:10-199): the hook names and a
per-object registry. The integrations (TensorBoard and the rest) are not
ported (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from yolo_ad_refine_tpu_torch.utils import LOGGER

HOOKS = (
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
)


class Callbacks:
    """Per-object callback registry; a failing callback is logged, not raised."""

    def __init__(self):
        self._callbacks: dict[str, list] = {h: [] for h in HOOKS}

    def add(self, event: str, callback):
        if event not in self._callbacks:
            raise KeyError(f"unknown hook {event!r}")
        self._callbacks[event].append(callback)

    def run(self, event: str, *args, **kwargs):
        for cb in self._callbacks.get(event, []):
            try:
                cb(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - a callback must not end training
                LOGGER.warning(f"callback {getattr(cb, '__name__', cb)} for {event} failed: {e}")
