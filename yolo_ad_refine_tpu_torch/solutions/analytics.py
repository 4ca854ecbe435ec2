"""Chart analytics over per-frame detection counts.

Parity surface: reference solutions/analytics.py Analytics — maintains a
rolling history of per-class counts and renders line / multi-line / bar /
pie / area charts as image frames (matplotlib Agg backend, returned as HWC
BGR uint8 arrays so they drop into the same video-writing path as the other
solutions).

Counterpart of ``yolo_ad_refine_tpu/solutions/analytics.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

MAX_POINTS = 45  # rolling window length (reference analytics.py max_points)


class Analytics:
    """chart_type in {'line', 'area', 'bar', 'pie'} (reference __init__)."""

    def __init__(self, chart_type: str = "line", names: dict | None = None,
                 figsize=(6.4, 3.8)):
        if chart_type not in {"line", "area", "bar", "pie"}:
            raise ValueError(f"chart_type {chart_type!r} is not line, area, bar or pie")
        self.chart_type = chart_type
        self.names = names or {}
        self.figsize = figsize
        self.frames: list[int] = []
        self.totals: list[int] = []
        self.classwise: dict[str, list[int]] = {}

    def update(self, frame_number: int, results) -> np.ndarray:
        """Feed one frame's Results; returns the rendered chart frame."""
        self.record(frame_number, results)
        return self.render()

    def record(self, frame_number: int, results) -> None:
        """Feed one frame's Results to the history without rendering (the
        counts need no matplotlib)."""
        boxes = results.boxes
        cls = np.asarray(boxes.cls).astype(int) if len(boxes) else np.zeros(0, int)
        counts = Counter(self.names.get(int(c), str(int(c))) for c in cls)
        self.frames.append(int(frame_number))
        self.totals.append(int(len(cls)))
        for name in set(self.classwise) | set(counts):
            hist = self.classwise.setdefault(name, [0] * (len(self.frames) - 1))
            hist.append(int(counts.get(name, 0)))
        if len(self.frames) > MAX_POINTS:
            self.frames = self.frames[-MAX_POINTS:]
            self.totals = self.totals[-MAX_POINTS:]
            self.classwise = {k: v[-MAX_POINTS:] for k, v in self.classwise.items()}

    def render(self) -> np.ndarray:
        """Render the current history to an HWC BGR uint8 frame."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=self.figsize, dpi=100)
        try:
            if self.chart_type == "line":
                ax.plot(self.frames, self.totals, marker="o", linewidth=2)
                ax.set_ylabel("total counts")
            elif self.chart_type == "area":
                keys = sorted(self.classwise)
                ax.stackplot(self.frames, [self.classwise[k] for k in keys],
                             labels=keys, alpha=0.7)
                if keys:
                    ax.legend(loc="upper left", fontsize=8)
                ax.set_ylabel("counts")
            elif self.chart_type == "bar":
                last = {k: v[-1] for k, v in self.classwise.items() if v and v[-1]}
                ax.bar(list(last.keys()), list(last.values()))
                ax.set_ylabel("counts")
            else:  # pie
                last = {k: v[-1] for k, v in self.classwise.items() if v and v[-1]}
                if last:
                    ax.pie(list(last.values()), labels=list(last.keys()),
                           autopct="%1.1f%%")
            if self.chart_type in ("line", "area", "bar"):
                ax.set_xlabel("frame" if self.chart_type != "bar" else "class")
                ax.grid(alpha=0.3)
            fig.tight_layout()
            fig.canvas.draw()
            rgba = np.asarray(fig.canvas.buffer_rgba())
            return rgba[..., 2::-1].copy()  # RGBA -> BGR
        finally:
            plt.close(fig)
