"""Verify parity against the PUBLISHED theaiinstitute hub checkpoints (port of theia_tpu/scripts/verify_published.py).

The reference's primary user flow is
``AutoModel.from_pretrained("theaiinstitute/theia-<size>-patch16-224-<set>",
trust_remote_code=True)`` (reference: README.md:23-38). This runbook runs
the shipped artifact through the port: it loads the published weights with
``theia_tpu_torch.models.hub.from_pretrained`` (the port's modules carry the
reference's parameter names), runs them on a fixed image set and, where the
reference model can be run too, asserts < 1e-3 feature MSE between the two;
it then stores a small activation fixture.

With ``--checkpoint`` (a local ``.safetensors``/``.pth`` copy, or a
checkpoint directory the port's trainer wrote) it runs offline. Without it,
it downloads ``model.safetensors`` from the hub, which needs a networked
machine with ``huggingface_hub``:

    python -m theia_tpu_torch.scripts.verify_published \
        --model theaiinstitute/theia-tiny-patch16-224-cdiv [--device cpu]

Steps performed:
  1. download ``model.safetensors`` (fallback ``pytorch_model.bin``) from
     the hub, or use ``--checkpoint``;
  2. run the port's model on a fixed seeded uint8 image set on ``--device``
     (the GPU unless ``--device cpu``);
  3. if the hub's trust_remote_code module is in the local cache, or the
     reference source tree is importable, run the SAME weights through the
     reference RobotVisionFM in torch on the CPU;
  4. assert feature/pred MSE < 1e-3 between the two, print a report, and
     write ``<fixture-dir>/published_<size>_<set>.npz`` holding the images,
     the reference's outputs and the port's (fp16) and, with
     ``--store-params``, the port's ``state_dict`` (fp16).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from theia_tpu_torch.ops import attention

IMAGE_SEED = 7
N_IMAGES = 4
TOL_MSE = 1e-3


def fixed_images(n: int = N_IMAGES) -> np.ndarray:
    """The fixed evaluation image set (seeded; the JAX runbook's)."""
    return np.random.RandomState(IMAGE_SEED).randint(
        0, 256, size=(n, 224, 224, 3), dtype=np.uint8
    )


def fixture_name(model_name: str) -> str:
    # theaiinstitute/theia-tiny-patch16-224-cdiv -> published_tiny_cdiv.npz
    tail = model_name.rsplit("/", 1)[-1]
    parts = tail.split("-")
    size = parts[1] if len(parts) > 1 else "tiny"
    tset = parts[-1] if parts[-1] not in ("224",) else "cdiv"
    return f"published_{size}_{tset}.npz"


def fetch_checkpoint(model_name: str) -> str:
    from huggingface_hub import hf_hub_download

    try:
        return hf_hub_download(model_name, "model.safetensors")
    except Exception:
        return hf_hub_download(model_name, "pytorch_model.bin")


def run_ours(model_name: str, checkpoint_path: str, images: np.ndarray, device: str = "cuda"):
    """The port's published entry point on ``device``, float32: (model,
    forward_feature, predictions) as float32 numpy."""
    from theia_tpu_torch.models.hub import from_pretrained

    model = from_pretrained(model_name, checkpoint_path=checkpoint_path, device=device)
    with torch.inference_mode():
        feat = model.forward_feature(images).float().cpu().numpy()
        preds = {k: v.float().cpu().numpy() for k, v in model(images).items()}
    return model, feat, preds


def run_reference_torch(model_name: str, checkpoint_path: str, images: np.ndarray):
    """Run the published weights through the reference RobotVisionFM.

    Tries, in order: (a) the hub's own trust_remote_code module (what the
    reference README tells users to run), from the local HF cache only, (b)
    the reference source tree executed offline via tests/golden_reference.py
    with the state dict loaded strict=False (reference rvfm.py:77-87
    semantics). Returns (feature, preds) as float32 numpy, or None if
    neither is available in this environment.
    """
    x = torch.from_numpy(images)

    try:  # (a) the published remote-code path
        from transformers import AutoModel

        model = AutoModel.from_pretrained(model_name, trust_remote_code=True, local_files_only=True)
        model.eval()
        with torch.no_grad():
            feat = model.forward_feature(x)
            preds = model(x)
        return feat.numpy().astype(np.float32), {
            k: v.numpy().astype(np.float32) for k, v in preds.items()
        }
    except Exception as e:
        print(f"[verify_published] remote-code reference unavailable: {e}")

    try:  # (b) reference source tree + the state dict
        repo_tests = Path(__file__).resolve().parents[2] / "tests"
        sys.path.insert(0, str(repo_tests))
        import golden_reference as gr
        from theia_tpu_torch.foundation.common import get_model_feature_size
        from theia_tpu_torch.models.hub import parse_model_name

        backbone, teachers = parse_model_name(model_name)
        sizes = {t: get_model_feature_size(t, keep_spatial=True) for t in teachers}
        cfg = gr.GoldenConfig(backbone=backbone, translator="lconv", sizes=sizes)
        gr.CONFIGS["_published"] = cfg
        model = gr.build_reference_rvfm("_published")

        if checkpoint_path.endswith(".safetensors"):
            from safetensors.torch import load_file

            sd = load_file(checkpoint_path)
        else:
            sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        if missing or unexpected:
            print(f"[verify_published] strict=False load: missing={missing[:4]}... "
                  f"unexpected={unexpected[:4]}...")
        model.eval()
        with torch.no_grad():
            feat = model.forward_feature(x)
            preds = model(x)
        return feat.numpy().astype(np.float32), {
            k: v.numpy().astype(np.float32) for k, v in preds.items()
        }
    except Exception as e:
        print(f"[verify_published] reference-source run unavailable: {e}")
    return None


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="theaiinstitute/theia-tiny-patch16-224-cdiv")
    ap.add_argument("--checkpoint", default=None, help="local .safetensors/.pth copy or checkpoint directory")
    ap.add_argument(
        "--fixture-dir",
        default=str(Path(__file__).resolve().parents[2] / "tests" / "fixtures"),
    )
    ap.add_argument("--device", default="cuda", help="the device the port's model runs on (default: cuda)")
    ap.add_argument(
        "--store-params",
        action="store_true",
        help="also store the port's state_dict in float16 (adds ~20-50 MB; lets an "
        "offline test recompute the outputs instead of trusting stored ones)",
    )
    args = ap.parse_args(argv)

    ckpt = args.checkpoint or fetch_checkpoint(args.model)
    images = fixed_images()

    before = attention.MHA_FWD_LAUNCHES, attention.FLASH_FWD_LAUNCHES
    ours_model, our_feat, our_preds = run_ours(args.model, ckpt, images, args.device)
    launches = {"mha_fwd": attention.MHA_FWD_LAUNCHES - before[0],
                "flash_fwd": attention.FLASH_FWD_LAUNCHES - before[1]}
    ref = run_reference_torch(args.model, ckpt, images)

    out: dict[str, np.ndarray] = {
        "images": images,
        "model_name": np.asarray(args.model),
        "ours::forward_feature": our_feat.astype(np.float16),
    }
    for k, v in our_preds.items():
        out[f"ours::pred::{k}"] = v.astype(np.float16)

    # the attention kernels' launches of the port's two calls (none on the CPU, whose path is the plain one)
    report = {"model": args.model, "checkpoint": ckpt, "device": args.device, "kernel_launches": launches,
              "reference_ran": ref is not None}
    ok = True
    if ref is not None:
        ref_feat, ref_preds = ref
        out["ref::forward_feature"] = ref_feat.astype(np.float16)
        mse = float(np.mean((our_feat - ref_feat) ** 2))
        report["forward_feature_mse"] = mse
        ok &= mse < TOL_MSE
        for k, v in ref_preds.items():
            out[f"ref::pred::{k}"] = v.astype(np.float16)
            m = float(np.mean((our_preds[k] - v) ** 2))
            report[f"pred_mse::{k}"] = m
            ok &= m < TOL_MSE
    if args.store_params:
        for key, leaf in ours_model.model.state_dict().items():
            out[f"param::{key}"] = leaf.detach().float().cpu().numpy().astype(np.float16)

    fx = Path(args.fixture_dir) / fixture_name(args.model)
    fx.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(fx, **out)
    report["fixture"] = str(fx)
    report["parity_ok"] = bool(ok) if ref is not None else None
    print(json.dumps(report, indent=2))
    if ref is not None and not ok:
        raise SystemExit(f"published-weight parity FAILED (> {TOL_MSE} MSE): {report}")
    return report


if __name__ == "__main__":
    main()
