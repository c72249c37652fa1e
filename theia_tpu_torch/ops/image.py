"""Image ops on the device: separable bicubic resize, center crop, DeiT preprocessing.

Port of theia_tpu/ops/image.py:21-212. The resampling matrices are the same
numpy code (``_cubic_kernel`` and the bicubic case of ``_resize_matrix``
are copies, checked equal by the tests); the two passes run as float32
matmuls on the tensor's device.

Layout: the public functions keep the JAX package's NHWC (or HWC) layout;
internally the passes run on NCHW so each is one plain matmul over the last
(W) or second-to-last (H) dim. TF32 must be off for float32 parity
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default): a
TF32 matmul moves values across the .5 boundary of the PIL rounding pass.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    """Cubic convolution kernel (Keys). a=-0.5 matches PIL, a=-0.75 matches torch."""
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    w = np.where(
        absx <= 1.0,
        (a + 2.0) * absx3 - (a + 3.0) * absx2 + 1.0,
        np.where(absx < 2.0, a * absx3 - 5.0 * a * absx2 + 8.0 * a * absx - 4.0 * a, 0.0),
    )
    return w


@functools.lru_cache(maxsize=64)
def _resize_matrix(
    in_size: int,
    out_size: int,
    a: float,
    scale: float | None,
    antialias: bool,
) -> np.ndarray:
    """Dense (out_size, in_size) separable bicubic sampling matrix (the JAX
    original's cubic, half-pixel case; its bilinear and align-corners cases
    have no caller on the port's path).

    Half-pixel mapping ``src = (dst + 0.5) / scale - 0.5``; ``scale`` may be
    overridden (the pos-embed h0+0.1 quirk); ``antialias`` stretches the
    support by 1/scale when downscaling (PIL semantics).
    """
    if scale is None:
        scale = out_size / in_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    if antialias and scale < 1.0:
        support_scale = scale
    else:
        support_scale = 1.0
    support = 2.0 / support_scale
    lo = np.floor(src - support).astype(np.int64)
    max_taps = int(np.ceil(2 * support)) + 2
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        taps = lo[i] + np.arange(max_taps)
        w = _cubic_kernel((src[i] - taps) * support_scale, a)
        s = w.sum()
        if s != 0:
            w = w / s
        # clamp taps to valid range (replicate border, matching torch/PIL)
        taps_c = np.clip(taps, 0, in_size - 1)
        for t, wt in zip(taps_c, w):
            mat[i, t] += wt
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(
    in_size: int,
    out_size: int,
    a: float,
    scale: float | None,
    antialias: bool,
    device: torch.device,
    dtype: torch.dtype,
) -> torch.Tensor:
    """``_resize_matrix`` as a device tensor, copied to the device once.

    Cached so a serving loop does not issue a synchronous host-to-device
    copy per call. Made outside inference mode: a matrix first cached by a
    call under ``torch.inference_mode()`` is still one autograd may save
    (the position-embedding interpolation of a training step)."""
    mat = _resize_matrix(in_size, out_size, a, scale, antialias)
    with torch.inference_mode(False):
        return torch.from_numpy(mat).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=16)
def _channel_constant(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """Per-channel float32 constant shaped [C, 1, 1] for NCHW broadcasting
    (made outside inference mode, as ``_resize_matrix_on``)."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32).reshape(-1, 1, 1).to(device)


def _resize_nchw(
    x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor, pil_uint8_rounding: bool
) -> torch.Tensor:
    if pil_uint8_rounding:
        # PIL resizes horizontally first and stores a uint8 intermediate;
        # torch.round rounds half to even, like jnp.round
        y = torch.matmul(x, mw.T).round_().clamp_(0.0, 255.0)
        return torch.matmul(mh, y).round_().clamp_(0.0, 255.0)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def bicubic_resize(
    x: torch.Tensor,
    out_h: int,
    out_w: int,
    *,
    a: float = -0.5,
    scale_h: float | None = None,
    scale_w: float | None = None,
    antialias: bool = True,
    pil_uint8_rounding: bool = False,
) -> torch.Tensor:
    """Separable bicubic resize of NHWC (or HWC) images via two matmuls.

    a=-0.5, antialias=True  -> PIL.Image.BICUBIC semantics.
    a=-0.75, antialias=False -> torch bicubic semantics.
    pil_uint8_rounding=True rounds and clamps to [0, 255] after each pass,
    horizontal pass first, as PIL does on a uint8 image.
    """
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, in_h, in_w, _ = x.shape
    dtype = x.dtype if x.is_floating_point() else torch.float32
    mh = _resize_matrix_on(in_h, out_h, a, scale_h, antialias, x.device, dtype)
    mw = _resize_matrix_on(in_w, out_w, a, scale_w, antialias, x.device, dtype)
    y = x.permute(0, 3, 1, 2).to(dtype, memory_format=torch.contiguous_format)
    y = _resize_nchw(y, mh, mw, pil_uint8_rounding).permute(0, 2, 3, 1)
    return y[0] if squeeze else y


def center_crop(x: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Center crop NHWC images. Matches HF image-processor center_crop offsets."""
    h, w = x.shape[-3], x.shape[-2]
    top = (h - crop_h) // 2
    left = (w - crop_w) // 2
    return x[..., top : top + crop_h, left : left + crop_w, :]


def preprocess_images(
    x: torch.Tensor,
    *,
    do_resize: bool = True,
    do_rescale: bool = True,
    do_normalize: bool = True,
    resize_size: int = 256,
    crop_size: int = 224,
    image_mean: tuple[float, float, float] = (0.5, 0.5, 0.5),
    image_std: tuple[float, float, float] = (0.5, 0.5, 0.5),
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """HF DeiT image-processor semantics on the tensor's device.

    Takes uint8 (or float) images [B,H,W,C] or [B,C,H,W] and returns
    normalized float NHWC (a permuted view of an NCHW tensor): resize to
    ``resize_size`` bicubic (PIL a=-0.5, uint8 rounding between passes) ->
    center crop ``crop_size`` -> rescale 1/255 -> normalize.
    """
    if x.dim() == 3:
        x = x[None]
    if not (x.shape[1] == 3 and x.shape[-1] != 3):
        x = x.permute(0, 3, 1, 2)  # channels-last input
    y = x.to(torch.float32, memory_format=torch.contiguous_format)  # [B,3,H,W]
    if do_resize:
        h, w = y.shape[-2:]
        f32 = torch.float32
        mh = _resize_matrix_on(h, resize_size, -0.5, None, True, y.device, f32)
        mw = _resize_matrix_on(w, resize_size, -0.5, None, True, y.device, f32)
        y = _resize_nchw(y, mh, mw, pil_uint8_rounding=True)
        y = center_crop(y.permute(0, 2, 3, 1), crop_size, crop_size).permute(0, 3, 1, 2)
    if do_rescale:
        y = y * (1.0 / 255.0)
    if do_normalize:
        y = (y - _channel_constant(tuple(image_mean), y.device)) / _channel_constant(
            tuple(image_std), y.device
        )
    return y.to(out_dtype).permute(0, 2, 3, 1)
