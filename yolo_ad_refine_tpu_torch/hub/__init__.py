"""HUB surface of the PyTorch port (counterpart of ``yolo_ad_refine_tpu/hub``;
reference ultralytics/hub/: auth, training-session sync, model upload and
export).

Cloud sync needs network access, which this deployment does not have: the
calls that would reach the service raise ``ConnectionError`` with the JAX
package's message, and the dataset check runs locally.
"""

from yolo_ad_refine_tpu_torch.utils import LOGGER

HUB_UNAVAILABLE = (
    "HUB features require network access, which this deployment disables. "
    "Checkpoints are fully local: see runs/<name>/weights/."
)


def login(api_key: str | None = None):
    raise ConnectionError(HUB_UNAVAILABLE)


def logout():
    LOGGER.info("hub: nothing to log out from (offline deployment)")


def export_model(model_id: str = "", format: str = "torchscript"):  # noqa: A002
    raise ConnectionError(HUB_UNAVAILABLE)


def check_dataset(path: str = "", task: str = "detect") -> dict:
    """Local-only dataset validation (the reference uploads to HUB after)."""
    from yolo_ad_refine_tpu_torch.data import check_det_dataset

    info = check_det_dataset(path)
    LOGGER.info(f"dataset ok: nc={info['nc']} names={list(info['names'].values())[:5]}...")
    return info
