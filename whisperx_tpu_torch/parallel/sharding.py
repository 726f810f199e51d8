"""The (data, model) device mesh and tensor-parallel placement.

Counterpart of ``whisperx_tpu/parallel/sharding.py``. The JAX package
annotates shardings and leaves the collectives to XLA; eager PyTorch has no
such compiler, so placement here is explicit:

  - a ``Mesh`` is an ``(n_data, n_model)`` grid of ``torch.device``s; a
    device may repeat (``["cuda:0", "cuda:0"]`` runs every split on one
    card);
  - ``shard_params_tp`` splits each block of a ``Whisper`` over the devices
    of a mesh row: whole attention heads (uneven counts allowed) and slices
    of the MLP's hidden width, as ``SplitLinear``s and a ``TPLayout`` the
    forward passes read (``models/whisper/model.py``); the row-split
    products are summed on the lead device (the in-process all-reduce);
  - every other data row holds a replica of its own, placed the same way
    over that row's devices (rows of the same devices share one);
  - ``shard`` has no eager meaning and returns its input: the forward
    passes place their work themselves.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

_state = threading.local()

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the linears split by output column (weight and bias) and by input row
# (weight only: the bias is added once, after the sum), as JAX's _tp_spec_for
COLUMN_SPLIT = ("query", "key", "value", "mlp1")
ROW_SPLIT = ("out", "mlp2")


class Mesh:
    """An ``(n_data, n_model)`` grid of devices: ``devices[r]`` is data row
    ``r``'s model axis, its first device the row's lead."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(row) for row in devices
        )

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device; none raises), ``n_model`` consecutive devices to a row."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices=[...] "
                "(e.g. [torch.device('cpu')] * 8) to build a mesh elsewhere"
            )
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    assert n_data * n_model == len(devices), (n_data, n_model, len(devices))
    return Mesh([devices[r * n_model : (r + 1) * n_model] for r in range(n_data)])


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the calling thread's active mesh inside the block."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def shard(x, *spec):
    """JAX's sharding annotation; placement in the port is explicit, so
    this returns ``x`` unchanged."""
    return x


def tp_spec_for(path: str, tensor: torch.Tensor) -> Optional[str]:
    """How a Whisper parameter at ``path`` (``/decoder/blocks/0/attn/query/w``)
    is placed: ``"col"`` (split along its last dim: the query, key, value
    and mlp1 weights and biases), ``"row"`` (along its first: the out and
    mlp2 weights) or None (whole, on the lead device)."""
    parts = path.split("/")
    name = parts[-2] if len(parts) >= 2 else ""
    if tensor.dim() < 2:
        return "col" if parts[-1] == "b" and name in COLUMN_SPLIT else None
    if name in COLUMN_SPLIT:
        return "col"
    if name in ROW_SPLIT:
        return "row"
    return None


def split_ranges(units: int, devices: Sequence[torch.device]) -> Tuple[Tuple[torch.device, int, int], ...]:
    """``units`` (heads, or columns) over ``devices`` as evenly as whole
    units allow, the first shards taking one more: (device, start, end) per
    shard that gets any."""
    n = len(devices)
    sizes = [units // n + (1 if i < units % n else 0) for i in range(n)]
    starts = [0, *itertools.accumulate(sizes)]
    return tuple(
        (dev, starts[i], starts[i + 1]) for i, dev in enumerate(devices) if sizes[i]
    )


class Placement(NamedTuple):
    """Where one parameter goes: ``spec`` as ``tp_spec_for``, and per shard
    (device, start, end) along the split dim (None: the lead device
    alone)."""

    spec: Optional[str]
    shards: Tuple[Tuple[torch.device, int, int], ...]

    def split(self, t: torch.Tensor, copy: bool = False) -> List[torch.Tensor]:
        """The shards of ``t``: views where a shard's device is ``t``'s and
        ``copy`` is off, else copies on the shard's device."""
        if self.spec is None:
            return [_move(t, self.shards[0][0], copy)]
        dim = -1 if self.spec == "col" else 0
        return [_move(t.narrow(dim, a, b - a), dev, copy) for dev, a, b in self.shards]


def _move(t: torch.Tensor, dev: torch.device, copy: bool) -> torch.Tensor:
    return t.to(dev, copy=True).contiguous() if copy else t.to(dev)


def _placement(path: str, t: torch.Tensor, dims, devices) -> Placement:
    spec = tp_spec_for(path, t)
    if spec is None:
        return Placement(None, ((devices[0], 0, 0),))
    width = t.shape[-1 if spec == "col" else 0]
    if path.split("/")[-2] in ("mlp1", "mlp2"):
        return Placement(spec, split_ranges(width, devices))
    n_head = dims.n_audio_head if path.startswith("/encoder") else dims.n_text_head
    dh = width // n_head
    return Placement(spec, tuple((d, a * dh, b * dh) for d, a, b in split_ranges(n_head, devices)))


def walk_params_tp(model, mesh: Mesh, leaf_fn: Callable, quant_fn: Callable, row: int = 0) -> dict:
    """Walk a ``Whisper``'s parameters with the placement policy over data
    row ``row`` of ``mesh``: ``{path: leaf_fn(tensor, Placement)}`` for
    every parameter and ``{path: quant_fn(module, Placement)}`` for every
    ``QuantizedLinear`` (never split: the lead device's). Shared by
    ``shard_params_tp`` and the tests, which walk a model on the ``meta``
    device at full width without allocating its weights."""
    from whisperx_tpu_torch.quant.core import QuantizedLinear

    devices = mesh.devices[row]
    out = {}
    for name, mod in model.named_modules():
        path = "/" + name.replace(".", "/") if name else ""
        if isinstance(mod, QuantizedLinear):
            out[path] = quant_fn(mod, Placement(None, ((devices[0], 0, 0),)))
            continue
        for pname, t in mod.named_parameters(recurse=False):
            leaf = f"{path}/{pname}"
            out[leaf] = leaf_fn(t, _placement(leaf, t, model.dims, devices))
    return out


def _linear_of(w: torch.Tensor, b: Optional[torch.Tensor]):
    from whisperx_tpu_torch.models.whisper.model import Linear

    lin = Linear(w.shape[0], w.shape[1], bias=b is not None, dtype=w.dtype, device="meta")
    lin.w = nn.Parameter(w, requires_grad=False)
    if b is not None:
        lin.b = nn.Parameter(b, requires_grad=False)
    return lin


def _blocks(model):
    for stack in ("encoder", "decoder"):
        for i, blk in enumerate(getattr(model, stack).blocks):
            yield f"/{stack}/blocks/{i}", blk


def _split_row(model, mesh: Mesh, row: int) -> None:
    """Place ``model`` (unplaced) over data row ``row``, in place."""
    from whisperx_tpu_torch.models.whisper.model import Linear, SplitLinear, TPLayout

    devices = mesh.devices[row]
    model.to(devices[0])
    if len(devices) == 1:
        return
    copy_ = len(set(devices)) > 1  # on one device the shards are views
    splits = walk_params_tp(
        model, mesh, lambda t, pl: (pl, pl.split(t, copy_)), lambda q, pl: None, row
    )
    dims = model.dims
    for prefix, blk in _blocks(model):
        if prefix.startswith("/encoder"):
            n_head, d = dims.n_audio_head, dims.n_audio_state
        else:
            n_head, d = dims.n_text_head, dims.n_text_state
        for owner in ("attn", "cross_attn", ""):
            parent = getattr(blk, owner, None) if owner else blk
            if parent is None:
                continue
            names = ("mlp1", "mlp2") if not owner else ("query", "key", "value", "out")
            for name in names:
                lin = getattr(parent, name)
                if not isinstance(lin, Linear):  # a QuantizedLinear stays whole
                    continue
                path = "/".join(p for p in (prefix, owner, name) if p)
                spec, ws = splits[f"{path}/w"]
                if spec.spec == "col":
                    bs = splits[f"{path}/b"][1] if lin.b is not None else [None] * len(ws)
                    split = SplitLinear([_linear_of(w, b) for w, b in zip(ws, bs)], None, rows=False)
                else:
                    split = SplitLinear([_linear_of(w, None) for w in ws], lin.b, rows=True)
                setattr(parent, name, split)
        blk.tp = TPLayout(split_ranges(n_head, devices), split_ranges(4 * d, devices))


def _unsplit(model) -> None:
    """Undo a placement: every ``SplitLinear`` back to one ``Linear`` on
    the lead device."""
    from whisperx_tpu_torch.models.whisper.model import SplitLinear

    for _, blk in _blocks(model):
        if blk.tp is None:
            continue
        lead = blk.tp.heads[0][0]
        for parent in (blk, blk.attn, getattr(blk, "cross_attn", None)):
            if parent is None:
                continue
            for name, lin in list(parent.named_children()):
                if not isinstance(lin, SplitLinear):
                    continue
                dim = 0 if lin.rows else -1
                w = torch.cat([p.w.to(lead) for p in lin.parts], dim=dim)
                if lin.rows:
                    b = lin.b
                elif lin.parts[0].b is not None:
                    b = torch.cat([p.b.to(lead) for p in lin.parts])
                else:
                    b = None
                setattr(parent, name, _linear_of(w, b))
        blk.tp = None
    for attr in ("_dp_mesh", "_dp_replicas"):
        model.__dict__.pop(attr, None)


def _replica(model, device: torch.device):
    """A copy of the (unplaced) model's structure with every tensor on
    ``device``: the same tensors where they already are there."""
    memo = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        moved = t.to(device)
        memo[id(t)] = nn.Parameter(moved, requires_grad=False) if isinstance(t, nn.Parameter) else moved
    return copy.deepcopy(model, memo)


def shard_params_tp(model, mesh: Mesh):
    """Place a ``Whisper`` on ``mesh``, IN PLACE, and return it: the model
    becomes data row 0's replica, split over that row's devices; every
    other row gets a replica of its own (rows of the same devices share
    one), all listed in ``model._dp_replicas``; ``model._dp_mesh`` records
    the mesh. A ``QuantizedLinear`` is not split: it stays whole on its
    row's lead device, where its product runs once (JAX replicates it on
    every device of the row). Placing on the mesh it is already on does
    nothing; another mesh first undoes the earlier placement."""
    placed = getattr(model, "_dp_mesh", None)
    if placed == mesh:
        return model
    if placed is not None:
        _unsplit(model)
    rows = mesh.devices
    replicas = {}
    for r, row in enumerate(rows):
        if r and row not in replicas and row != rows[0]:
            rep = _replica(model, row[0])
            _split_row(rep, mesh, r)
            replicas[row] = rep
    _split_row(model, mesh, 0)
    replicas[rows[0]] = model
    model._dp_mesh = mesh
    model._dp_replicas = [replicas[row] for row in rows]
    return model
