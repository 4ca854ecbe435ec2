"""Config merge + validation.

Counterpart of ``yolo_ad_refine_tpu/cfg/config.py`` (reference
cfg/__init__.py: get_cfg:225, check_cfg:277-334 per-key type and range
checks, check_dict_alignment:402-440 unknown keys with difflib suggestions,
_handle_deprecation:367-399). ``cfg/default.yaml`` is a byte-identical copy
of the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

from yolo_ad_refine_tpu_torch.utils import DEFAULT_CFG_PATH, LOGGER, colorstr, yaml_load

CFG_FLOAT_KEYS = {"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "batch",
                  "pose", "kobj"}
CFG_FRACTION_KEYS = {  # floats constrained to [0.0, 1.0]
    "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr",
    "hsv_h", "hsv_s", "hsv_v", "translate", "scale", "perspective", "flipud",
    "fliplr", "mosaic", "mixup", "copy_paste", "conf", "iou", "fraction",
}
CFG_INT_KEYS = {"epochs", "patience", "workers", "seed", "close_mosaic", "max_det",
                "vid_stride", "line_width", "nbs", "save_period", "max_boxes"}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
    "val", "save_json", "half", "plots", "show", "save_txt", "save_conf", "save_crop",
    "show_labels", "show_conf", "visualize", "augment", "agnostic_nms", "amp",
    "profile", "multi_scale", "pretrained", "fsdp",
}
# keys accepted besides default.yaml's (runtime/meta, not hyperparameters)
EXTRA_KEYS = {"model", "data", "mode", "task", "resume", "save_dir", "tracker",
              "kpt_shape", "flip_idx", "space", "autobatch_fraction", "rect_buckets"}

DEPRECATED = {  # old key -> (new key, value transform)
    "boxes": ("show_boxes", lambda v: v),
    "hide_labels": ("show_labels", lambda v: str(v) == "False"),
    "hide_conf": ("show_conf", lambda v: str(v) == "False"),
    "line_thickness": ("line_width", lambda v: v),
}


def handle_deprecation(custom: dict) -> dict:
    """Map deprecated keys to their current names (reference cfg:367-399)."""
    for old, (new, fn) in DEPRECATED.items():
        if old in custom:
            LOGGER.warning(f"'{old}' is deprecated, use '{new}' instead")
            custom[new] = fn(custom.pop(old))
    return custom


def check_dict_alignment(base: dict, custom: dict):
    """Error on unknown keys with fuzzy suggestions (reference cfg:402-440)."""
    custom = handle_deprecation(custom)
    mismatched = [k for k in custom if k not in base and k not in EXTRA_KEYS]
    if mismatched:
        from difflib import get_close_matches

        msg = ""
        for x in mismatched:
            matches = get_close_matches(x, list(base))
            matches = [f"{k}={base[k]}" if base.get(k) is not None else k for k in matches]
            hint = f" Similar arguments are: {matches}." if matches else ""
            msg += f"'{colorstr('red', str(x))}' is not a valid argument.{hint}\n"
        raise SyntaxError(msg)


def check_cfg(cfg: dict, hard: bool = True) -> dict:
    """Type/range validation in-place (reference cfg/__init__.py:277-334)."""
    for k, v in cfg.items():
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS and not isinstance(v, (int, float)):
            if hard:
                raise TypeError(f"'{k}={v}' is of invalid type {type(v).__name__}; "
                                f"'{k}' must be an int or float")
            cfg[k] = float(v)
        elif k in CFG_FRACTION_KEYS:
            if not isinstance(v, (int, float)):
                if hard:
                    raise TypeError(f"'{k}={v}' is of invalid type {type(v).__name__}; "
                                    f"'{k}' must be an int or float")
                cfg[k] = v = float(v)
            if not (0.0 <= float(v) <= 1.0):
                raise ValueError(f"'{k}={v}' is an invalid value; valid '{k}' values "
                                 f"are between 0.0 and 1.0.")
        elif k in CFG_INT_KEYS and not isinstance(v, int):
            if hard and not (isinstance(v, float) and v.is_integer()):
                raise TypeError(f"'{k}={v}' is of invalid type {type(v).__name__}; "
                                f"'{k}' must be an int")
            cfg[k] = int(v)
        elif k in CFG_BOOL_KEYS and not isinstance(v, bool):
            if hard and str(v).lower() not in ("true", "false", "0", "1"):
                raise TypeError(f"'{k}={v}' is of invalid type {type(v).__name__}; "
                                f"'{k}' must be a bool")
            cfg[k] = str(v).lower() in ("true", "1")
    return cfg


def get_cfg(overrides: dict | None = None, cfg: str | Path | dict | None = None) -> dict:
    """default.yaml + overrides merge with alignment + type checks
    (reference cfg/__init__.py:225-275 get_cfg)."""
    base = dict(yaml_load(cfg) if isinstance(cfg, (str, Path)) else
                (cfg or yaml_load(DEFAULT_CFG_PATH)))
    overrides = dict(overrides or {})
    check_dict_alignment(base, overrides)
    merged = {**base, **overrides}
    for k in ("project", "name"):
        if k in merged and isinstance(merged[k], (int, float)):
            merged[k] = str(merged[k])
    check_cfg(merged)
    return merged
