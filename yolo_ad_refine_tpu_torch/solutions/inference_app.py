"""Interactive browser inference app.

Parity surface: reference solutions/streamlit_inference.py inference() — a
Streamlit page with model/source/confidence controls streaming annotated
frames. Streamlit is not part of this build's baked environment, so the app
degrades explicitly: with streamlit installed it serves the same surface;
without it, ``inference`` raises with install guidance, and the
dependency-free ``run_headless`` helper provides the identical
predict-and-annotate loop for scripts and tests.

Counterpart of ``yolo_ad_refine_tpu/solutions/inference_app.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

from pathlib import Path


def run_headless(model, source, conf: float = 0.25, iou: float = 0.45,
                 classes=None, max_frames: int | None = None):
    """The app's core loop without any UI: yields (frame_idx, Results)."""
    results = model.predict(source=source, conf=conf, iou=iou, stream=True)
    for i, r in enumerate(results):
        if classes is not None:
            r = r.filter_classes(classes) if hasattr(r, "filter_classes") else r
        yield i, r
        if max_frames is not None and i + 1 >= max_frames:
            break


def inference(model_path: str | Path = "yolo11n.yaml", **kwargs):
    """Launch the Streamlit UI (reference streamlit_inference.py:13)."""
    try:
        import streamlit as st
    except ImportError as e:  # pragma: no cover - env without streamlit
        raise ImportError(
            "streamlit is required for the browser inference app "
            "(pip install streamlit); for scripted use call "
            "solutions.inference_app.run_headless instead"
        ) from e

    from yolo_ad_refine_tpu_torch.models.yolo import YOLO

    st.set_page_config(page_title="yolo-ad-refine-tpu inference")
    st.title("Real-time inference")
    conf = st.sidebar.slider("Confidence", 0.0, 1.0, 0.25, 0.01)
    iou = st.sidebar.slider("IoU", 0.0, 1.0, 0.45, 0.01)
    source = st.sidebar.text_input("Source", "0")
    model = YOLO(str(model_path))
    frame_slot = st.empty()
    if st.sidebar.button("Start"):
        for _, r in run_headless(model, source, conf=conf, iou=iou, **kwargs):
            frame_slot.image(r.plot()[..., ::-1], channels="RGB")
