"""Long-lived flood-mask inference server (port of
``floodplanet_code_tpu/inference/serve.py``).

The reference's deployment is a shell loop that re-launches infer.py per
scene directory (Batch_infer.sh:12-26): every invocation pays interpreter
start, checkpoint restore and model build. This daemon loads the
checkpoint once, keeps the model on the card (with its fused-conv operands
packed once, ``models/unet.py::DoubleConv``), and serves the same per-root
workflow over HTTP:

    python -m floodplanet_code_tpu_torch.inference.serve <checkpoint> \\
        [--host 127.0.0.1] [--port 8765] [--tta] [--device cpu]

    GET  /healthz
        -> {"status": "ok", "device": "cuda:0", "devices": N,
            "model_loaded": bool, ...}
    POST /infer   {"root": "/data/scenes/T1", "split": "all",
                   "save_dir": "...", "dataset": "floodplanet"}
        -> {"written": [mask paths], "root": ..., "seconds": t}

Requests are serialized by a lock (one model, one stream of work on the
card); handler threads share the CUDA context, and ``infer`` enters
inference mode itself, which is per thread. Masks are written exactly as
the batch CLI writes them (georeferenced uint8 GeoTIFFs). Status codes:
400 for a body that is not JSON or lacks ``root``, 404 for an unknown path
or a root that does not exist, 500 with the exception's text otherwise.

Two sources, exactly one of which must be given:
- ``checkpoint_path``: restore the model and run its predict step;
- ``artifact_path``: a program exported by ``tools/export_model.py``
  (``<out>.pt2`` beside its ``<out>.json`` manifest): the frozen predict
  step runs as it is, with the weights inside. TTA and the batch and tile
  shape were fixed at export time; the manifest records them, the requests
  are run at that shape and every batch is checked against it. The
  experiment (config, default save directory) is the manifest's
  ``checkpoint``'s.

    python -m floodplanet_code_tpu_torch.inference.serve --artifact <out>.pt2 \\
        [--port 8765] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.inference.infer import (
    build_infer_dataset,
    infer,
    load_model_for_eval,
    model_key,
)
from floodplanet_code_tpu_torch.tools.export_model import ARTIFACT_SUFFIX, load_exported


class InferenceService:
    """Holds the warm model and runs per-root inference requests."""

    def __init__(
        self,
        checkpoint_path: str | None = None,
        tta: bool = False,
        artifact_path: str | None = None,
        device="cuda",
    ):
        if (checkpoint_path is None) == (artifact_path is None):
            raise ValueError("give exactly one of checkpoint_path / artifact_path")
        self.device = resolve_device(device)
        self.checkpoint_path = checkpoint_path
        self.artifact_path = artifact_path
        self.manifest = None
        source = checkpoint_path
        if artifact_path is not None:
            base = os.path.normpath(artifact_path).removesuffix(ARTIFACT_SUFFIX)
            with open(base + ".json") as handle:
                self.manifest = json.load(handle)
            if tta and not self.manifest["tta"]:
                raise ValueError(
                    "--tta requested but this artifact was exported with tta=false; "
                    "TTA is baked in at export time"
                )
            tta = bool(self.manifest["tta"])
            # The artifact may live anywhere (--out); its experiment dir
            # comes from the recorded checkpoint provenance.
            source = self.manifest["checkpoint"]
        self.tta = tta
        self.experiment_dir = os.path.dirname(os.path.dirname(os.path.normpath(source)))
        self.cfg = load_experiment_config(self.experiment_dir)
        self._lock = threading.Lock()  # one request on the card at a time
        # The model on self.device, or the artifact's checked predict step.
        self._warm = None
        self._warm_key = None  # model_key() of the dataset it was built for

    def _warm_model(self, dataset):
        """Load the checkpoint, or the artifact, once per (channels,
        classes) shape."""
        key = model_key(dataset)
        if self._warm is None or self._warm_key != key:
            if self.artifact_path is not None:
                self._warm = _artifact_step(load_exported(self.artifact_path),
                                            self.manifest["inputs"])
            else:
                self._warm = load_model_for_eval(self.cfg, self.checkpoint_path, dataset,
                                                 self.device)
            self._warm_key = key
        return self._warm

    def infer_root(
        self,
        root: str,
        split: str = "all",
        save_dir: str | None = None,
        dataset_name: str | None = None,
    ) -> dict:
        if not os.path.isdir(root):
            raise FileNotFoundError(f"scene root does not exist: {root}")
        dataset_name = dataset_name or self.cfg.dataset.name
        save_dir = save_dir or os.path.join(
            self.experiment_dir, "serve_inference", os.path.basename(os.path.normpath(root))
        )
        with self._lock:
            start = time.perf_counter()
            run_cfg = copy.deepcopy(self.cfg)
            # A request names a whole root: no held-out region applies.
            run_cfg.eval_region = None
            if self.manifest is not None:
                # The artifact's batch and tile are frozen: tile and batch
                # exactly so (tpu.inference_batch_size too, which infer()
                # prefers over batch_size).
                shape = self.manifest["inputs"]["image"]["shape"]
                run_cfg.batch_size = int(shape[0])
                run_cfg.crop_height, run_cfg.crop_width = int(shape[1]), int(shape[2])
                run_cfg.tpu["inference_batch_size"] = int(shape[0])
            # The probe is infer()'s own dataset (non-overlapping tiles over
            # this root); it also decides the model's shape.
            probe = build_infer_dataset(run_cfg, dataset_name, split, root_dir=root)
            warm = self._warm_model(probe)
            artifact = self.artifact_path is not None
            written = infer(
                run_cfg,
                self.checkpoint_path,
                dataset_name,
                split,
                save_dir,
                tta=self.tta,
                warm=None if artifact else warm,
                predict_step=warm if artifact else None,
                dataset=probe,
                device=self.device,
            )
            return {
                "root": root,
                "written": written,
                "seconds": round(time.perf_counter() - start, 3),
            }

    @property
    def model_loaded(self) -> bool:
        return self._warm is not None


def _artifact_step(call, inputs: dict):
    """The predict step over an exported program: the NCHW views
    ``sliding_window_predict`` passes go back to the program's NHWC inputs,
    each held to the manifest's shape first."""

    def step(batch: dict):
        feed = {}
        for name, spec in inputs.items():
            value = batch[name].permute(0, 2, 3, 1)
            got = list(value.shape)
            if got != spec["shape"]:
                raise ValueError(
                    f"artifact expects {name} {spec['shape']}, request produced {got} — "
                    "re-export with matching batch/tile shape"
                )
            feed[name] = value
        return call(feed)

    return step


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            on_card = service.device.type == "cuda"
            self._reply(
                200,
                {
                    "status": "ok",
                    "device": str(service.device),
                    "devices": torch.cuda.device_count() if on_card else 1,
                    "model_loaded": service.model_loaded,
                    "checkpoint": service.checkpoint_path,
                    "artifact": service.artifact_path,
                },
            )

        def do_POST(self):
            if self.path != "/infer":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as exc:
                self._reply(400, {"error": f"bad JSON body: {exc}"})
                return
            # Validate request fields outside the service's try-block, so a
            # KeyError from inside the service is a 500, not a misleading
            # 400 "missing field".
            if not isinstance(req, dict) or "root" not in req:
                self._reply(400, {"error": "missing field: 'root'"})
                return
            try:
                result = service.infer_root(
                    root=req["root"],
                    split=req.get("split", "all"),
                    save_dir=req.get("save_dir"),
                    dataset_name=req.get("dataset"),
                )
                self._reply(200, result)
            except FileNotFoundError as exc:
                self._reply(404, {"error": str(exc)})
            except Exception as exc:  # surface it, keep the server up
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

        def log_message(self, fmt, *args):  # quiet default access logs
            pass

    return Handler


def serve(
    checkpoint_path: str | None = None,
    host: str = "127.0.0.1",
    port: int = 8765,
    tta: bool = False,
    artifact_path: str | None = None,
    device="cuda",
) -> ThreadingHTTPServer:
    """Build the HTTP server (the caller runs ``serve_forever()``); port 0
    picks a free port (``server.server_address[1]``). Raises without a card
    unless ``device="cpu"``."""
    service = InferenceService(checkpoint_path, tta=tta, artifact_path=artifact_path,
                               device=device)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.service = service  # exposed for tests
    return server


def main(argv=None):
    parser = argparse.ArgumentParser(description="Long-lived flood-mask inference server.")
    parser.add_argument("checkpoint_path", type=str, nargs="?", default=None)
    parser.add_argument(
        "--artifact",
        type=str,
        default=None,
        help="Serve a program exported by tools/export_model.py (<out>.pt2, its "
        "manifest beside it) instead of a checkpoint.",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--tta",
        action="store_true",
        help="Dihedral test-time augmentation on every request.",
    )
    args = parser.parse_args(argv)
    server = serve(args.checkpoint_path, args.host, args.port, tta=args.tta,
                   artifact_path=args.artifact, device=args.device)
    source = (f"artifact {args.artifact}" if args.artifact
              else f"checkpoint {args.checkpoint_path}")
    print(
        f"[serve] listening on http://{args.host}:{server.server_address[1]} "
        f"({source}, device {server.service.device})",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
