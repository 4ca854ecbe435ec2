"""Persistent user settings.

Counterpart of ``yolo_ad_refine_tpu/utils/settings.py`` (reference
utils/__init__.py:1142 SettingsManager): a JSON dict at a per-user path
holding directory defaults and integration toggles, with the JAX package's
schema and version, schema validation on load, key and type checks in
``update`` and ``reset``. The file lives under the port's own name,
``~/.config/yolo_ad_refine_tpu_torch/settings.json``, so the two packages
keep separate settings.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

from yolo_ad_refine_tpu_torch.utils import LOGGER, colorstr

SETTINGS_FILE = Path.home() / ".config" / "yolo_ad_refine_tpu_torch" / "settings.json"


class SettingsManager(dict):
    """JSON-persisted settings dict (reference SettingsManager semantics)."""

    def __init__(self, file: str | Path = SETTINGS_FILE, version: str = "0.0.6"):
        super().__init__()
        self.file = Path(file)
        self.version = version
        self.lock = threading.Lock()
        root = Path.cwd()
        self.defaults = {
            "settings_version": version,
            "datasets_dir": str((root / "datasets").resolve()),
            "weights_dir": str((root / "weights").resolve()),
            "runs_dir": str((root / "runs").resolve()),
            "sync": False,           # zero-egress: telemetry off
            "api_key": "",
            "tensorboard": True,
            "mlflow": True,
            "jsonl": True,
            "clearml": False,
            "comet": False,
            "dvc": False,
            "hub": False,
            "neptune": False,
            "raytune": False,
            "wandb": False,
            "vscode_msg": False,
        }
        dict.update(self, self.defaults)
        if not self.file.exists():
            self.save()
            return
        try:
            loaded = json.loads(self.file.read_text())
        except (json.JSONDecodeError, OSError):
            LOGGER.warning(f"{colorstr('Settings:')} unreadable {self.file}; resetting")
            self.save()
            return
        if loaded.get("settings_version", "") == version and set(loaded) == set(self.defaults):
            dict.update(self, loaded)
        else:
            LOGGER.warning(f"{colorstr('Settings:')} schema mismatch at {self.file}; "
                           "resetting to defaults")
            self.save()

    def save(self):
        with self.lock:
            self.file.parent.mkdir(parents=True, exist_ok=True)
            self.file.write_text(json.dumps(dict(self), indent=2))

    def update(self, *args, **kwargs):  # noqa: D102 - dict.update with validation
        new = dict(*args, **kwargs)
        for k, v in new.items():
            if k not in self.defaults:
                raise KeyError(f"unknown setting '{k}'; valid keys: {list(self.defaults)}")
            t = type(self.defaults[k])
            if not isinstance(v, t):
                raise TypeError(f"setting '{k}' must be {t.__name__}, got {type(v).__name__}")
        super().update(new)
        self.save()

    def reset(self):
        """Reset to defaults and persist (reference SettingsManager.reset)."""
        self.clear()
        dict.update(self, self.defaults)
        self.save()


_settings = None


def get_settings() -> SettingsManager:
    """The process's settings, read from ``SETTINGS_FILE`` at first use."""
    global _settings
    if _settings is None:
        _settings = SettingsManager()
    return _settings
