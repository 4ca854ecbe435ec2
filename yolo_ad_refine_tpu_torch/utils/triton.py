"""Triton Inference Server client (KServe v2 over HTTP).

Counterpart of ``yolo_ad_refine_tpu/utils/triton.py`` (reference
utils/triton.py TritonRemoteModel): a remote-model handle built from
``http://<host:port>/<model>`` whose ``__call__`` maps numpy inputs to numpy
outputs, the inputs coerced to the types the model's metadata names and the
outputs returned in the alphabetical order of their names, cast back to the
caller's type. It speaks Triton's open KServe-v2 REST protocol with the
binary tensor extension (a JSON header, then the tensors' little-endian
bytes) through ``urllib``, with ``json`` and ``numpy`` and nothing else.
The JAX package's ``grpc://`` route needs the ``tritonclient`` package,
which neither this image nor the card machine has: it raises here.
"""

from __future__ import annotations

import json
import urllib.request
from urllib.parse import urlsplit

import numpy as np

_DTYPES = {
    "FP32": np.float32, "FP16": np.float16, "UINT8": np.uint8,
    "INT8": np.int8, "INT32": np.int32, "INT64": np.int64,
    "FP64": np.float64, "BOOL": np.bool_,
}
_NP2TRITON = {np.dtype(v).name: k for k, v in _DTYPES.items()}


class TritonRemoteModel:
    """Remote Triton model: ``TritonRemoteModel('http://host:8000/yolo')``."""

    def __init__(self, url: str, endpoint: str = "", scheme: str = ""):
        if not endpoint and not scheme:
            splits = urlsplit(url)
            endpoint = splits.path.strip("/").split("/")[0]
            scheme = splits.scheme
            url = splits.netloc
        self.endpoint = endpoint
        self.url = url
        self.scheme = scheme or "http"
        if self.scheme != "http":
            raise ValueError(f"Triton over {self.scheme}:// needs the tritonclient package, which "
                             "is not installed; serve the model over http://")
        meta = self._get_json(f"/v2/models/{endpoint}")
        self.input_names = [x["name"] for x in meta["inputs"]]
        self.input_formats = [x["datatype"] for x in meta["inputs"]]
        self.output_names = sorted(x["name"] for x in meta["outputs"])
        self.np_input_formats = [_DTYPES[f] for f in self.input_formats]

    def _get_json(self, path: str) -> dict:
        with urllib.request.urlopen(f"http://{self.url}{path}", timeout=30) as r:
            return json.loads(r.read())

    def _infer_rest(self, inputs: list[np.ndarray]) -> list[np.ndarray]:
        """One KServe v2 binary-tensor inference request."""
        header = {
            "inputs": [{"name": self.input_names[i], "shape": list(x.shape),
                        "datatype": _NP2TRITON[x.dtype.name],
                        "parameters": {"binary_data_size": x.nbytes}}
                       for i, x in enumerate(inputs)],
            "outputs": [{"name": n, "parameters": {"binary_data": True}}
                        for n in self.output_names],
        }
        hbytes = json.dumps(header).encode()
        body = hbytes + b"".join(np.ascontiguousarray(x).tobytes() for x in inputs)
        req = urllib.request.Request(
            f"http://{self.url}/v2/models/{self.endpoint}/infer", data=body,
            headers={"Content-Type": "application/octet-stream",
                     "Inference-Header-Content-Length": str(len(hbytes))})
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
            jlen = int(r.headers.get("Inference-Header-Content-Length", len(raw)))
        resp = json.loads(raw[:jlen])
        blob = raw[jlen:]
        outs = {}
        offset = 0
        for o in resp["outputs"]:
            dt = np.dtype(_DTYPES[o["datatype"]])
            n = int(np.prod(o["shape"])) if o["shape"] else 1
            size = o.get("parameters", {}).get("binary_data_size", n * dt.itemsize)
            arr = np.frombuffer(blob[offset:offset + size], dtype=dt)
            outs[o["name"]] = arr.reshape(o["shape"])
            offset += size
        return [outs[n] for n in self.output_names]

    def __call__(self, *inputs: np.ndarray) -> list[np.ndarray]:
        caller_dtype = inputs[0].dtype
        coerced = [np.asarray(x, self.np_input_formats[i]) for i, x in enumerate(inputs)]
        return [o.astype(caller_dtype) for o in self._infer_rest(coerced)]
