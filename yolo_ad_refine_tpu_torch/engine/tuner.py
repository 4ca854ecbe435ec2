"""Hyperparameter evolution (reference engine/tuner.py:33-241).

Counterpart of ``yolo_ad_refine_tpu/engine/tuner.py``: pick a parent from
the top-n previous results (fitness-weighted), perturb each hyperparameter
with probability ``mutation`` by a clipped Gaussian factor, clamp to the
search-space bounds, train, record the fitness in ``tune_results.csv``,
keep the best iteration's weights and ``best_hyperparameters.yaml``.

As in the JAX package, each iteration trains in-process (here through the
port's ``DetectionTrainer``) and draws its mutation from a numpy generator
seeded with ``seed + i``; ``_mutate`` makes the same draws in the same
order as the JAX ``Tuner._mutate``, so the same ``tune_results.csv`` and
seed give the same hyperparameters, bit for bit.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np

from yolo_ad_refine_tpu_torch.utils import (
    DEFAULT_CFG_PATH, LOGGER, TryExcept, colorstr, increment_path, yaml_load, yaml_save)

# key: (min, max[, gain]) — reference tuner.py:78-104, the JAX package's space
DEFAULT_SPACE = {
    "lr0": (1e-5, 1e-1),
    "lrf": (0.0001, 0.1),
    "momentum": (0.7, 0.98, 0.3),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "warmup_momentum": (0.0, 0.95),
    "box": (1.0, 20.0),
    "cls": (0.2, 4.0),
    "dfl": (0.4, 6.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "degrees": (0.0, 45.0),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.95),
    "shear": (0.0, 10.0),
    "perspective": (0.0, 0.001),
    "flipud": (0.0, 1.0),
    "fliplr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
    "mixup": (0.0, 1.0),
    "copy_paste": (0.0, 1.0),
}


class Tuner:
    """Evolve hyperparameters by mutate -> train -> score iterations; the
    results go to ``<project>/tune[n]/``."""

    def __init__(self, args: dict, space: dict | None = None):
        self.space = dict(space or DEFAULT_SPACE)
        self.args = dict(args)
        self.args.pop("space", None)
        project = self.args.get("project") or "runs"
        self.tune_dir = increment_path(Path(project) / "tune",
                                       exist_ok=bool(self.args.get("exist_ok", False)),
                                       mkdir=True)
        self.tune_csv = self.tune_dir / "tune_results.csv"
        self.prefix = colorstr("Tuner:")
        LOGGER.info(f"{self.prefix} tune_dir={self.tune_dir}")

    def _mutate(self, rng: np.random.Generator, parent: str = "single", n: int = 5,
                mutation: float = 0.8, sigma: float = 0.2) -> dict:
        """Fitness-weighted parent selection from the CSV history and clipped
        Gaussian factor mutation (reference tuner.py:116-158); without a
        history, the run's own values (or default.yaml's)."""
        defaults = yaml_load(DEFAULT_CFG_PATH)
        if self.tune_csv.exists():
            x = np.loadtxt(self.tune_csv, ndmin=2, delimiter=",", skiprows=1)
            fitness = x[:, 0]
            n = min(n, len(x))
            x = x[np.argsort(-fitness)][:n]
            w = x[:, 0] - x[:, 0].min() + 1e-6
            if parent == "single" or len(x) == 1:
                x = x[rng.choice(n, p=w / w.sum())]
            else:  # weighted combination of the top-n parents
                x = (x * w.reshape(n, 1)).sum(0) / w.sum()
            g = np.array([v[2] if len(v) == 3 else 1.0 for v in self.space.values()])
            ng = len(self.space)
            v = np.ones(ng)
            while (v == 1).all():  # mutate until something changes
                v = (g * (rng.random(ng) < mutation) * rng.standard_normal(ng)
                     * rng.random() * sigma + 1).clip(0.3, 3.0)
            hyp = {k: float(x[i + 1] * v[i]) for i, k in enumerate(self.space)}
        else:
            hyp = {k: float(self.args.get(k, defaults.get(k, 0.0))) for k in self.space}
        for k, bounds in self.space.items():
            hyp[k] = round(min(max(hyp[k], bounds[0]), bounds[1]), 5)
        return hyp

    def __call__(self, model_factory=None, iterations: int = 10, cleanup: bool = True) -> dict:
        """Run the evolution. ``model_factory()`` gives each iteration its
        starting model (None: the trainer builds ``args['model']``).
        Returns the best hyperparameters. An iteration whose training
        raises is logged and scored 0, as in the JAX package."""
        from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

        t0 = time.time()
        (self.tune_dir / "weights").mkdir(parents=True, exist_ok=True)
        best, best_metrics = {}, None
        for i in range(iterations):
            rng = np.random.default_rng(int(self.args.get("seed", 0)) + i)
            hyp = self._mutate(rng)
            LOGGER.info(f"{self.prefix} iteration {i + 1}/{iterations} hyp={hyp}")
            train_args = {**self.args, **hyp, "project": str(self.tune_dir),
                          "name": f"iter{i + 1}", "exist_ok": True, "plots": False}
            metrics, save_dir = {}, None
            try:
                trainer = DetectionTrainer(overrides=train_args,
                                           model=model_factory() if model_factory else None)
                metrics = trainer.train()
                save_dir = Path(metrics["save_dir"])
            except Exception as e:  # noqa: BLE001 - a bad hyp combination must not end the run
                LOGGER.warning(f"{self.prefix} iteration {i + 1} training failed: "
                               f"{type(e).__name__}: {e}")

            fitness = float(metrics.get("fitness", metrics.get("best_fitness", 0.0)))
            header = "" if self.tune_csv.exists() else ",".join(["fitness", *self.space]) + "\n"
            with open(self.tune_csv, "a") as f:
                f.write(header + ",".join(
                    map(str, [round(fitness, 5)] + [hyp[k] for k in self.space])) + "\n")

            x = np.loadtxt(self.tune_csv, ndmin=2, delimiter=",", skiprows=1)
            best_idx = int(x[:, 0].argmax())
            if best_idx == i and save_dir is not None:
                best_metrics = {k: round(v, 5) for k, v in metrics.items()
                                if isinstance(v, (int, float))}
                wdir = save_dir / "weights"
                if wdir.exists():
                    for ckpt in wdir.iterdir():
                        dst = self.tune_dir / "weights" / ckpt.name
                        if ckpt.is_dir():
                            shutil.copytree(ckpt, dst, dirs_exist_ok=True)
                        else:
                            shutil.copy2(ckpt, dst)
            elif cleanup and save_dir is not None:
                shutil.rmtree(save_dir / "weights", ignore_errors=True)

            best = {k: float(x[best_idx, j + 1]) for j, k in enumerate(self.space)}
            yaml_save(self.tune_dir / "best_hyperparameters.yaml", best)
            LOGGER.info(f"{self.prefix} {i + 1}/{iterations} done ({time.time() - t0:.1f}s); "
                        f"best fitness {x[best_idx, 0]:.5f} at iteration {best_idx + 1}; "
                        f"best metrics {best_metrics}")
        self._plot()
        return best

    @TryExcept("tune plot failed")
    def _plot(self):
        """Fitness against iteration, ``tune_fitness.png`` (reference
        plotting.py plot_tune_results)."""
        from yolo_ad_refine_tpu_torch.utils.plotting import _pyplot

        plt = _pyplot()
        x = np.loadtxt(self.tune_csv, ndmin=2, delimiter=",", skiprows=1)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(np.arange(1, len(x) + 1), x[:, 0], "o-", ms=4)
        ax.set_xlabel("iteration")
        ax.set_ylabel("fitness")
        ax.set_title("hyperparameter evolution")
        fig.tight_layout()
        fig.savefig(self.tune_dir / "tune_fitness.png", dpi=120)
        plt.close(fig)
