"""Hopper kernel: a 3x3 convolution (stride 1, padding 1) over lanes that
each hold their own weights, in one launch per direction.

Replaces no TPU kernel: the JAX package leaves its CNN's convolutions to
XLA (``src/repro/models/cnn.py``, ``jax.lax.conv_general_dilated``).  It
was added for local training, where ``torch.func.vmap`` batches a client's
forward and backward over lanes: vmap makes each ``F.conv2d`` and its
backward a cuDNN grouped convolution (groups = lanes), whose fp32 engines
loop over the lanes, about 47 kernels a lane and SGD step.  Source:
``csrc/conv_lanes.cu``, CUDA C++ for sm_90a.  Bound: operations over the
fp32 peak (67 TFLOP/s without tensor cores), 2·B·H·W·Cout·9·Cin a lane and
direction; the bytes are about 70 times fewer at the paper's widths.

Design (the source's header has the rest): strict fp32 fmaf, no TF32.  The
forward and the input gradient run as a direct convolution over pixel tiles
with a haloed input patch in shared memory (no im2col buffer); the weight
gradient sums over a lane's pixels, split over the blocks of a cluster when
few lanes leave few blocks, and added in rank order, so runs repeat.
:func:`plan` picks every tile and split from the shapes alone (nothing is
tuned at run time).  Activations are NHWC in memory within a lane: the
wrappers take and return the model's logical (L, B, C, H, W) shapes as
views of NHWC storage, so the permutes around the model's convolutions are
free, and a caller whose tensors are laid out otherwise pays one copy.

:func:`forward`, :func:`input_grad` and :func:`weight_grad` only launch
the kernel: they take fp32 tensors on the current CUDA device and raise on
anything else, a refused launch included; nothing falls back to another
route.  ``kernels.ops`` routes CPU tensors to the plain versions in
``kernels.ref`` (``conv_lanes_ref`` and its gradients: the grouped
convolution vmap makes of ``F.conv2d``).  ``conv_lanes.launches`` counts every
launch, ``launches_forward``, ``launches_input_grad`` and
``launches_weight_grad`` each direction's.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

# ConvArgs of csrc/conv_lanes.cu: src, aux, bias, out, out_bias, stream; the
# lane strides of src, aux, bias; lanes, batch, height, width, cin, cout,
# direction, bn, ck, imgs, rows, split
_ARGS = struct.Struct("6Q3q12i")
DIRECTIONS = ("forward", "input_grad", "weight_grad")

THREADS = 256  # forward and input grad (kThreads in the .cu)
WGRAD_N = 32  # output channels a weight-grad block (kWgradN)
WGRAD_PIXELS = 128  # pixels a weight-grad tile (kWgradPixels)
MAX_SMEM = 232_448  # bytes of shared memory a block may use on sm_90 (kMaxSmem)
MAX_SPLIT = 8  # the largest portable cluster


def pixel_tile(h: int, w: int, bm: int) -> Tuple[int, int]:
    """(images, rows) of a tile of at most ``bm`` pixels: whole images where
    one fits, else whole rows of one image."""
    if h * w <= bm:
        return bm // (h * w), h
    if w > bm:
        raise ValueError(f"conv_lanes: images {w} pixels wide exceed a tile of {bm} pixels")
    return 1, bm // w


@functools.cache
def plan(direction: str, lanes: int, batch: int, h: int, w: int, cin: int, cout: int, sms: int) -> Dict[str, int]:
    """Tiles, split and shared memory of one launch, from the shapes alone.

    forward / input_grad: ``bn`` output channels a block (32, 64 or 128, the
    least that holds them), ``ck`` summed channels a step (4 where 4 hold
    them, else 16 beside a 32-channel tile and 8 beside the wider ones),
    pixel tiles of 256 pixels beside a 32-channel tile and 128 beside the
    others.  weight_grad: 32 output x ``bn`` input channels a block (8 where
    8 hold them, else 32), 128-pixel tiles, and the pixel sum split over
    ``split`` blocks (1-8): the least power of 2 that gives 4 blocks an SM,
    while every block keeps at least 2 tiles of the sum."""
    if direction == "weight_grad":
        bn, ck, bm = (8 if cin <= 8 else 32), 0, WGRAD_PIXELS
    else:
        n, kc = (cout, cin) if direction == "forward" else (cin, cout)
        bn = 32 if n <= 32 else 64 if n <= 64 else 128
        ck = 4 if kc <= 4 else 16 if bn == 32 else 8
        bm = 256 if bn == 32 else 128
    imgs, rows = pixel_tile(h, w, bm)
    ppx = imgs * (rows + 2) * (w + 2)
    split = 1
    if direction == "weight_grad":
        blocks = lanes * -(-cout // WGRAD_N) * -(-cin // bn)
        ktiles = -(-batch // imgs) * -(-h // rows)
        while split < MAX_SPLIT and blocks * split < 4 * sms and ktiles >= 4 * split:
            split *= 2
        stages = 2 * (imgs * rows * w * (WGRAD_N + 4) + ppx * (bn + 4))
        smem = 4 * max(stages, 9 * WGRAD_N * bn + 10 * WGRAD_N)
    else:
        smem = 4 * 2 * (ppx * (ck + 4) + 9 * ck * bn)
    if smem > MAX_SMEM:
        raise ValueError(f"conv_lanes: a {h}x{w} image's tile needs {smem} bytes of shared memory (max {MAX_SMEM})")
    return {"bn": bn, "ck": ck, "imgs": imgs, "rows": rows, "split": split, "smem": smem}


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _launcher():
    fn = build.library("conv_lanes").conv_lanes_launch
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def _check_conv(stride, padding, w: torch.Tensor) -> None:
    if tuple(w.shape[-2:]) != (3, 3) or stride != 1 or padding != 1:
        raise ValueError(f"conv_lanes takes 3x3 kernels, stride 1, padding 1; got {tuple(w.shape[-2:])}, "
                         f"stride {stride}, padding {padding}")


def _fp32(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"conv_lanes takes float32; {name} is {t.dtype}")


def _device(*tensors: torch.Tensor) -> int:
    index = tensors[0].get_device()
    return index if all(t.get_device() == index for t in tensors) else -2  # -2: launch_stream raises


def _lanes_dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each lane (dim 0) dense in its own order, copied if it is not."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != want:
            return t.contiguous()
        want *= size
    return t


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """A (L, B, C, H, W) tensor as its (L, B, H, W, C) view, each lane dense."""
    return _lanes_dense(t.permute(0, 1, 3, 4, 2))


def _lane_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else 0


def _launch_words(out: torch.Tensor, words) -> None:
    err = _launcher()(_ARGS.pack(*words))
    if err != 0:
        raise RuntimeError(f"conv_lanes {DIRECTIONS[words[15]]} launch failed: CUDA error {err}")


# Every launch runs inside this operator, so that a trace links the kernel
# to the operator and through it to the ranges open around the call (a bare
# ctypes launch links to nothing).  The dispatcher adds about 10 us a launch
# on the host, 23 launches a VAoI SGD step.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("conv_lanes_launch(Tensor(a!) out, int[] words) -> ()")
_LIB.impl("conv_lanes_launch", _launch_words, "CUDA")


def _launch(direction: str, src, aux, bias, out, out_bias, lanes, batch, h, w, cin, cout, index) -> None:
    stream = build.launch_stream("conv_lanes", index)
    _launcher()  # builds the library at first use (raises without nvcc) before the operator is dispatched
    p = plan(direction, lanes, batch, h, w, cin, cout, sm_count(index))
    words = (
        src.data_ptr(), aux.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
        0 if out_bias is None else out_bias.data_ptr(), stream,
        _lane_stride(src), _lane_stride(aux), 0 if bias is None else _lane_stride(bias),
        lanes, batch, h, w, cin, cout, DIRECTIONS.index(direction), p["bn"], p["ck"], p["imgs"], p["rows"],
        p["split"],
    )
    torch.ops.repro_torch.conv_lanes_launch(out, list(words))
    conv_lanes.launches += 1
    setattr(conv_lanes, f"launches_{direction}", getattr(conv_lanes, f"launches_{direction}") + 1)


def forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int = 1,
            padding: int = 1) -> torch.Tensor:
    """x (L, B, Cin, H, W), w (L, Cout, Cin, 3, 3), b (L, Cout) or None ->
    y (L, B, Cout, H, W), NHWC in memory."""
    _check_conv(stride, padding, w)
    tensors = dict(x=x, w=w) if b is None else dict(x=x, w=w, b=b)
    _fp32(**tensors)
    lanes, batch, cin, h, wd = x.shape
    cout = w.shape[1]
    if w.shape != (lanes, cout, cin, 3, 3) or (b is not None and b.shape != (lanes, cout)):
        raise ValueError(f"conv_lanes: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {None if b is None else tuple(b.shape)} are not (L, B, Cin, H, W), "
                         "(L, Cout, Cin, 3, 3), (L, Cout)")
    index = _device(*tensors.values())
    xs, ws = _nhwc(x), _lanes_dense(w)
    bs = None if b is None else _lanes_dense(b)
    y = torch.empty((lanes, batch, h, wd, cout), dtype=torch.float32, device=x.device)
    if y.numel():
        _launch("forward", xs, ws, bs, y, None, lanes, batch, h, wd, cin, cout, index)
    return y.permute(0, 1, 4, 2, 3)


def input_grad(g: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """g = dL/dy (L, B, Cout, H, W), w (L, Cout, Cin, 3, 3) -> dL/dx
    (L, B, Cin, H, W), NHWC in memory."""
    _check_conv(stride, padding, w)
    _fp32(g=g, w=w)
    lanes, batch, cout, h, wd = g.shape
    cin = w.shape[2]
    if w.shape != (lanes, cout, cin, 3, 3):
        raise ValueError(f"conv_lanes: g {tuple(g.shape)} and w {tuple(w.shape)} are not (L, B, Cout, H, W), "
                         "(L, Cout, Cin, 3, 3)")
    index = _device(g, w)
    gs, ws = _nhwc(g), _lanes_dense(w)
    dx = torch.empty((lanes, batch, h, wd, cin), dtype=torch.float32, device=g.device)
    if dx.numel():
        _launch("input_grad", gs, ws, None, dx, None, lanes, batch, h, wd, cin, cout, index)
    return dx.permute(0, 1, 4, 2, 3)


def weight_grad(g: torch.Tensor, x: torch.Tensor, stride: int = 1, padding: int = 1,
                kernel_size: Tuple[int, int] = (3, 3)) -> Tuple[torch.Tensor, torch.Tensor]:
    """g = dL/dy (L, B, Cout, H, W), x (L, B, Cin, H, W) -> (dL/dw
    (L, Cout, Cin, 3, 3), dL/db (L, Cout)), contiguous."""
    if tuple(kernel_size) != (3, 3) or stride != 1 or padding != 1:
        raise ValueError(f"conv_lanes takes 3x3 kernels, stride 1, padding 1; got {tuple(kernel_size)}, "
                         f"stride {stride}, padding {padding}")
    _fp32(g=g, x=x)
    lanes, batch, cout, h, wd = g.shape
    cin = x.shape[2]
    if x.shape != (lanes, batch, cin, h, wd):
        raise ValueError(f"conv_lanes: g {tuple(g.shape)} and x {tuple(x.shape)} differ but for channels")
    index = _device(g, x)
    gs, xs = _nhwc(g), _nhwc(x)
    dw = torch.empty((lanes, cout, cin, 3, 3), dtype=torch.float32, device=g.device)
    db = torch.empty((lanes, cout), dtype=torch.float32, device=g.device)
    if batch * h * wd == 0:
        return dw.zero_(), db.zero_()
    if dw.numel():
        _launch("weight_grad", gs, xs, None, dw, db, lanes, batch, h, wd, cin, cout, index)
    return dw, db


def conv_lanes(direction: str, *args, **kwargs):
    """The kernel in ``direction`` (one of :data:`DIRECTIONS`): the counters'
    home in ``kernels.ops.KERNELS``."""
    return {"forward": forward, "input_grad": input_grad, "weight_grad": weight_grad}[direction](*args, **kwargs)


conv_lanes.launches = 0
for _d in DIRECTIONS:
    setattr(conv_lanes, f"launches_{_d}", 0)
