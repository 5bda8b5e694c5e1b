"""Production-mesh dry run: build and run one step of every (architecture
x input shape) as rank 0 of the production mesh, on fake tensors
(``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod | --both-meshes] [--out results.json]

The reference lowers and compiles the step for 256 (512) forced host
devices.  Here the mesh is a ``DeviceMesh`` over the fake backend
(``launch/mesh.py``), the inputs are fake tensors at full size
(``launch/specs.py``) turned into DTensors by the partition rules
(``launch/sharding.py``), and the step runs once, eagerly, under
``implicit_replication()`` (a plain tensor made inside the model, such
as the RoPE tables or a mask, meets the DTensors as replicated).  The
train step includes the backward pass and AdamW.  Nothing is allocated
and no kernel runs (``impl="torch"``).

DTensor picks each op's layout greedily, and refuses some reshards
that GSPMD makes silently; ``Reshard`` makes the layouts GSPMD picks
on the reference's specs (the Megatron ones) and those reshards, and
the record lists every site it used (``reshards``).

The record keeps the reference's keys, counted on rank 0's local
shards (``StepCounter``):
  * ``flops``: matmul, convolution and attention flops as
    ``torch.utils.flop_counter`` counts them (elementwise work is not
    counted);
  * ``bytes_accessed``: operand and result bytes of every op, unfused
    and views excluded, so an upper bound of what a fused program moves;
  * ``collective_bytes``: result bytes of the collectives the step
    issues, by the reference's five kinds; ``collective_elements``, their
    result elements (the reference's compile for host devices promotes
    bf16 all-reduces to f32, so elements compare across the two);
  * ``argument_bytes`` / ``output_bytes``: the step's local inputs and
    outputs; ``peak_bytes``: the most bytes live at once over the step,
    inputs included; ``temp_bytes``: the peak less the inputs.
``lower_s`` is the time to build the inputs and the step, ``compile_s``
the time of the eager run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import weakref
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (make_production_mesh, model_axis_size,
                                     teardown)
from repro_torch.models import layers
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import (make_serve_prefill,
                                             make_serve_step,
                                             make_train_step)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# op-name fragments of the c10d and functional collectives, by kind
_KIND_OF = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("send", "collective-permute"), ("recv", "collective-permute"))


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func._opname
    for frag, kind in _KIND_OF:
        if frag in name:
            return kind
    return None


def _tensors(tree):
    out = []
    torch.utils._pytree.tree_map_only(torch.Tensor, out.append, tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_sharding_propagation() -> bool:
    """Whether the op being dispatched was called by DTensor's sharding
    propagation, which runs the op on global-shape fake tensors to learn
    the output's metadata: no rank runs it."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class StepCounter(TorchDispatchMode):
    """What rank 0 runs, op by op.  An op on DTensors is handed back
    (``NotImplemented``) so that DTensor first turns it into this
    rank's local ops and collectives, which come back here on plain
    tensors and are counted.  The ops DTensor's sharding propagation
    runs (at global shapes, under the step's own fake mode) are not.

    Memory is counted the same way: every storage an op makes is live
    from the op until its last tensor goes, and ``peak_bytes`` is the
    most live at once, the inputs (``track``) included.  (MemTracker
    would count the propagation's global-shape temporaries too: its
    guard against them holds only for a step that runs outside a
    FakeTensorMode.)"""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes = {k: 0 for k in _COLLECTIVES}
        self.collective_elements = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()

    def track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen.add(st)
                n = st.nbytes()
                self.live += n
                weakref.finalize(st, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        if func._opname == "wait_tensor":     # an alias of its input
            return out
        self.track(_tensors(out))
        kind = _collective_kind(func)
        if kind is not None:
            self.collective_bytes[kind] += sum(map(_nbytes, _tensors(out)))
            self.collective_elements[kind] += sum(
                t.numel() for t in _tensors(out))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view and func.namespace == "aten":
            self.bytes_accessed += sum(map(_nbytes, _tensors(
                (args, kwargs, out))))
        return out


class Reshard(TorchFunctionMode):
    """The reshards GSPMD makes and DTensor refuses, made explicitly:

    * an embedding lookup ``table[tokens]`` of a vocab-sharded table,
      and ``torch.gather`` along a sharded dim: DTensor moves the table
      (an all-to-all to hidden-sharded rows) or gathers the operand
      whole, and cannot carry its own masked partial through the
      indexing that follows; GSPMD takes locally, masked, and
      all-reduces (``_masked_local``);
    * a ``reshape`` / ``view`` that splits a sharded dim unevenly (a
      head split the model axis does not divide): the dim is gathered
      first;
    * ``logsumexp`` over a sharded dim: a max and a sum, each reduced;
    * a sum or mean over a sharded dim: its partial result reduced at
      once (DTensor may not add partial sums to partial means);
    * a scatter (``index_put_``) of batch-sharded values into a
      per-sequence buffer made inside the model, and the take back from
      it (the MoE dispatch of ``moe_impl="gspmd"``): each rank scatters
      into and takes from its own sequences' rows, so the buffer stays
      sharded on the batch, as GSPMD keeps the reference's ``vmap`` over
      the batch (``_per_sequence``);
    * a depthwise ``conv1d`` over sharded channels: each rank convolves
      its channels;
    * ``x[:, i]`` along an unsharded dim: each rank takes from what it
      holds (DTensor's backward of such a take, an ``index_put``, fails
      on some versions);
    * ``einsum``: each rank's shards (``_einsum``);
    * ``x @ w`` with a column-, row-sharded or replicated weight: the
      Megatron layout (``_linear``).

    Each local product keeps, in the backward pass, the layout of its
    forward values (``_Pin``), as GSPMD keeps a cotangent in its
    primal's sharding.

    ``sites`` names each rule used, with the model's line that reached
    it."""

    def __init__(self):
        super().__init__()
        self.sites = {}

    def _linear(self, x: DTensor, w: DTensor) -> DTensor:
        """``x @ w`` in the Megatron layout the rules imply: x whole on
        the model axis before a column-sharded or replicated weight,
        sharded on its last dim before a row-sharded one; the row
        product's partial sums reduced at once."""
        mi = w.device_mesh.mesh_dim_names.index("model")
        wp = w.placements[mi]
        row = getattr(wp, "dim", None) is not None \
            and wp.dim % w.ndim == w.ndim - 2
        want = Shard(x.ndim - 1) if row else Replicate()
        if x.placements[mi] != want:
            self._note("matmul operand layout")
            place = list(x.placements)
            place[mi] = want
            x = x.redistribute(placements=place)
        out = _pin(x) @ w
        return _pin(_replicate_partial(out) if row else out)

    def _note(self, rule: str):
        import traceback
        frame = next((f for f in reversed(traceback.extract_stack()[:-2])
                      if "repro_torch" in f.filename
                      and "launch/dryrun" not in f.filename), None)
        where = (f"{frame.filename.split('src/')[-1]}:{frame.lineno}"
                 if frame else "?")
        key = f"{rule} at {where}"
        self.sites[key] = self.sites.get(key, 0) + 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.backward and len(args) == 1 \
                and not any(kwargs.get(k) for k in (
                    "gradient", "retain_graph", "create_graph", "inputs")):
            # the mode is off while its handler runs: run the engine with
            # it on, so the layers remat recomputes are resharded too
            loss = args[0]
            grad = torch.ones_like(loss)
            with self:
                torch.autograd.graph._engine_run_backward(
                    (loss,), (grad,), False, False, (),
                    allow_unreachable=True, accumulate_grad=True)
            return None
        if func in (torch.Tensor.matmul, torch.matmul) \
                and _is_weight(args[1]) and isinstance(args[0], DTensor):
            return self._linear(*args)
        if func is torch.einsum and any(isinstance(a, DTensor)
                                        for a in args[1:]):
            return _einsum(args[0], *args[1:])
        if func is torch.Tensor.index_put_ \
                and not isinstance(args[0], DTensor) \
                and isinstance(args[2], DTensor):
            self._note("scatter into a per-sequence buffer")
            return _per_sequence(args[0], args[1], args[2], **kwargs)
        if func is torch.conv1d and isinstance(args[0], DTensor) \
                and kwargs.get("groups", 1) == args[0].shape[1] > 1:
            self._note("depthwise conv over sharded channels")
            return _depthwise_conv(*args, **kwargs)
        if func is torch.Tensor.__getitem__ and _is_column_take(*args):
            self._note("take along an unsharded dim")
            return _local_take(*args)
        if func is torch.Tensor.__getitem__ and _is_sequence_take(*args):
            self._note("take from a per-sequence buffer")
            return _per_sequence(args[0], args[1])
        if func is torch.Tensor.__getitem__ and _is_lookup(*args):
            self._note("embedding lookup")
            return _vocab_lookup(*args)
        if func is torch.logsumexp and isinstance(args[0], DTensor) \
                and _shards_dim(args[0], kwargs.get("dim", args[1]
                                                    if len(args) > 1
                                                    else None)):
            self._note("logsumexp over a sharded dim")
            x = args[0]
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            m = _replicate_partial(x.amax(dim, keepdim=True)).detach()
            lse = _replicate_partial((x - m).exp().sum(dim, keepdim=True))
            return (lse.log() + m).squeeze(dim)
        if func in _REDUCTIONS and isinstance(args[0], DTensor):
            out = func(*args, **kwargs)
            if isinstance(out, DTensor) \
                    and any(p.is_partial() for p in out.placements):
                self._note("reduction over a sharded dim")
                out = _pin(_replicate_partial(out))
            return out
        if func is torch.gather and isinstance(args[0], DTensor) \
                and not kwargs and _shards_dim(args[0], args[1]):
            self._note("gather on a sharded dim")
            return _sharded_gather(*args)
        if func in (torch.Tensor.reshape, torch.Tensor.view) \
                and isinstance(args[0], DTensor):
            gather = _uneven_split(args[0], args[1:])
            if gather:
                self._note("uneven head split")
                t = args[0]
                return func(t.redistribute(placements=[
                    Replicate() if i in gather else p
                    for i, p in enumerate(t.placements)]), *args[1:],
                    **kwargs)
        return func(*args, **kwargs)


_REDUCTIONS = (torch.sum, torch.mean, torch.Tensor.sum, torch.Tensor.mean)
def _is_weight(w) -> bool:
    return isinstance(w, DTensor) and w.ndim == 2 \
        and "model" in w.device_mesh.mesh_dim_names


def _is_column_take(x, idx) -> bool:
    """``x[:, i]`` with a 1-D index tensor, ``x`` a DTensor not sharded
    on dim 1 (the MoE dispatch's token take)."""
    return (isinstance(x, DTensor) and isinstance(idx, tuple)
            and len(idx) == 2 and idx[0] == slice(None)
            and isinstance(idx[1], torch.Tensor) and idx[1].ndim == 1
            and not idx[1].is_floating_point()
            and not _shards_dim(x, 1))


def _is_sequence_take(x, idx) -> bool:
    """``x[i, j, ...]`` with index tensors on a DTensor sharded on its
    batch dim 0 and on no other (the MoE's take back from its
    per-sequence buffer)."""
    return (isinstance(x, DTensor) and bool(_shards_dim(x, 0))
            and all(getattr(p, "dim", 0) % x.ndim == 0
                    for p in x.placements)
            and isinstance(idx, tuple)
            and all(isinstance(i, torch.Tensor) for i in idx))


def _per_sequence(buf, idx: tuple, vals: Optional[DTensor] = None,
                  accumulate: bool = False) -> DTensor:
    """``buf[idx]``, or ``buf.index_put_(idx, vals, accumulate)`` for a
    plain ``buf`` made inside the model, where ``idx[0]`` holds each
    row's own sequence: on each rank, over its sequences' rows of
    ``buf`` (``idx[0]`` less the rank's first row), laid out on the
    batch as ``vals`` (a scatter) or ``buf`` (a take) is."""
    src = buf if vals is None else vals
    mesh = src.device_mesh
    dims = _shards_dim(src, 0)
    place = [Shard(0) if i in dims else p if vals is None else Replicate()
             for i, p in enumerate(src.placements)]
    idx_place = [Shard(0) if i in dims else Replicate()
                 for i in range(mesh.ndim)]
    rep = [Replicate()] * mesh.ndim
    tensors = [i if isinstance(i, DTensor) else DTensor.from_local(
        i, mesh, rep, run_check=False) for i in idx]

    def local(s_l, *i_l):
        lo = _first_index(mesh, dims, s_l.shape[0])
        i_l = (i_l[0] - lo,) + i_l[1:]
        if vals is None:
            return s_l[i_l]
        rows = buf.narrow(0, lo, s_l.shape[0]).clone()
        return rows.index_put_(i_l, s_l, accumulate=accumulate)

    return _pin(_local(local, mesh, (place,) + (idx_place,) * len(idx),
                       place, _pin(src), *tensors))


def _local_take(x: DTensor, idx: tuple) -> DTensor:
    """``x[idx]`` on each rank's shards, laid out as ``x``, the index
    tensors whole on every rank (DTensor's backward of such a take, an
    ``index_put``, fails on some versions)."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    where = [k for k, i in enumerate(idx) if isinstance(i, torch.Tensor)]
    tensors = [idx[k] if isinstance(idx[k], DTensor) else DTensor.from_local(
        idx[k], mesh, rep, run_check=False) for k in where]

    def take(x_l, *i_l):
        full = list(idx)
        for k, i in zip(where, i_l):
            full[k] = i
        return x_l[tuple(full)]

    return _pin(_local(take, mesh, (x.placements,) + (rep,) * len(where),
                       list(x.placements), _pin(x), *tensors))


def _is_lookup(table, idx) -> bool:
    return (isinstance(table, DTensor) and isinstance(idx, torch.Tensor)
            and not idx.is_floating_point() and idx.dtype != torch.bool
            and table.ndim == 2
            and any(getattr(p, "dim", None) == 0 for p in table.placements))


def _depthwise_conv(x: DTensor, w, bias=None, stride=1, padding=0,
                    dilation=1, groups=1) -> DTensor:
    """A depthwise ``conv1d`` (``groups`` = channels) of ``x [B, C, L]``
    on each rank's channels: the weight's channel sharding (its dim 0)
    is the input's (dim 1), the batch keeps its sharding, and each rank
    convolves its channels with ``groups`` = its channel count."""
    mesh = x.device_mesh
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x_place = [Shard(1) if getattr(wp, "dim", None) == 0
               else xp if getattr(xp, "dim", None) == 0 else Replicate()
               for xp, wp in zip(x.placements, w.placements)]
    w_place = [Shard(0) if p == Shard(1) else Replicate() for p in x_place]
    args, places = [x, w], [x_place, w_place]
    if bias is not None:
        args.append(bias)
        places.append(w_place[:])

    def local(x_l, w_l, *b_l):
        return torch.conv1d(x_l, w_l, *b_l, stride=stride, padding=padding,
                            dilation=dilation, groups=x_l.shape[1])

    return _pin(_local(local, mesh, places, x_place, *args))


def _local(fn, mesh, in_places, out_place, *args) -> DTensor:
    """``local_map`` of ``fn`` on ``args`` laid out by ``in_places``,
    with each input's gradient laid out as GSPMD's transpose lays it
    (``local_map`` would lay it out as the input): a partial sum over a
    mesh dim that the input is replicated on while another input or the
    output is split over it, whole where the input was a partial sum."""
    split = {i for pl in list(in_places) + [out_place]
             for i, p in enumerate(pl) if p != Replicate()}
    grads = tuple([Replicate() if p.is_partial()
                   else Partial() if p == Replicate() and i in split else p
                   for i, p in enumerate(pl)] for pl in in_places)
    return local_map(fn, out_placements=out_place,
                     in_placements=tuple(in_places),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _shards_dim(t: DTensor, dim: int) -> list:
    """The mesh dims that shard ``t``'s dim ``dim``."""
    return [i for i, p in enumerate(t.placements)
            if getattr(p, "dim", None) is not None
            and p.dim % t.ndim == dim % t.ndim]


def _first_index(mesh, dims, size: int):
    """This rank's first index along a tensor dim sharded over the mesh
    dims ``dims`` (major to minor) in chunks of ``size``."""
    lo = 0
    for i in dims:
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    return lo * size


def _masked_local(x: DTensor, dims: list, idx: DTensor, idx_place, fn):
    """``fn(x_local, local_index, hit)`` on every rank, where the index
    is taken into this rank's chunk of ``x`` along the mesh dims
    ``dims`` (zeros where it falls outside, ``hit`` False), then the
    partial results summed over ``dims``: the vocab-parallel lookup of
    Megatron, which GSPMD makes of a gather along a sharded dim."""
    mesh = x.device_mesh
    out_place = [Partial() if i in dims else p
                 for i, p in enumerate(idx_place)]
    d = x.placements[dims[0]].dim

    def local(x_l, i_l):
        lo = _first_index(mesh, dims, x_l.shape[d])
        hit = (i_l >= lo) & (i_l < lo + x_l.shape[d])
        return fn(x_l, torch.where(hit, i_l - lo, torch.zeros_like(i_l)),
                  hit)

    out = _local(local, mesh, (x.placements, idx_place), out_place, x, idx)
    return _pin(_replicate_partial(out))


def _vocab_lookup(table: DTensor, idx: DTensor) -> DTensor:
    """``table[idx]`` for a table sharded on its rows."""
    dims = _shards_dim(table, 0)
    idx_place = [Replicate() if i in dims else p
                 for i, p in enumerate(idx.placements)]
    return _masked_local(table, dims, idx, idx_place,
                         lambda t, i, hit: t[i] * hit[..., None].to(t.dtype))


def _sharded_gather(x: DTensor, dim: int, idx) -> DTensor:
    """``torch.gather(x, dim, idx)`` along a dim ``x`` shards; the index
    takes ``x``'s layout on the other dims."""
    dims = _shards_dim(x, dim)
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, x.device_mesh,
                                 [Replicate()] * x.device_mesh.ndim,
                                 run_check=False)
    idx_place = [Replicate() if i in dims else p
                 for i, p in enumerate(x.placements)]
    return _masked_local(x, dims, idx, idx_place,
                         lambda t, i, hit: torch.gather(t, dim, i)
                         * hit.to(t.dtype))


class _Pin(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the value was
    laid out (GSPMD keeps a cotangent in its primal's sharding; DTensor
    would take whatever layout its backward strategies choose)."""

    @staticmethod
    def forward(ctx, t):
        ctx.place = t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.place:
            g = g.redistribute(placements=ctx.place)
        return g


def _pin(t: DTensor) -> DTensor:
    return _Pin.apply(t) if t.requires_grad else t


def _einsum(eq: str, *ops) -> DTensor:
    """``torch.einsum`` on each rank's shards (GSPMD's product rule): a
    label sharded over a mesh dim in one operand is sharded the same way
    in every operand that has it; a label of the output stays sharded,
    a contracted one leaves partial sums, reduced at once.  Two labels
    sharded over one mesh dim keep the first operand's."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = next(o for o in ops if isinstance(o, DTensor)).device_mesh
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    in_place = [list(o.placements) for o in ops]
    out_place = []
    for i in range(mesh.ndim):
        label = next((lab[p.dim % len(lab)] for lab, o in zip(ins, ops)
                      for p in [o.placements[i]]
                      if getattr(p, "dim", None) is not None), None)
        for k, lab in enumerate(ins):
            in_place[k][i] = (Shard(lab.index(label))
                              if label is not None and label in lab
                              else Replicate())
        out_place.append(Replicate() if label is None
                         else Shard(out.index(label)) if label in out
                         else Partial())
    ops = [_pin(o.redistribute(placements=p) if list(o.placements) != p
                else o) for o, p in zip(ops, in_place)]
    res = _local(lambda *ls: torch.einsum(eq, *ls), mesh, in_place,
                 out_place, *ops)
    return _pin(_replicate_partial(res))


def _replicate_partial(t: DTensor) -> DTensor:
    return t.redistribute(placements=[
        Replicate() if p.is_partial() else p for p in t.placements])


def _uneven_split(t: DTensor, shape_args) -> set:
    """The mesh dims to gather before ``t.reshape(*shape_args)``: those
    sharding a dim that the reshape splits into dims whose leading one
    the shard count does not divide."""
    shape = shape_args[0] if len(shape_args) == 1 and isinstance(
        shape_args[0], (tuple, list, torch.Size)) else shape_args
    shape = list(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = t.numel() // max(known, 1)
    by_dim = {}
    for i, p in enumerate(t.placements):
        if getattr(p, "dim", None) is not None:
            by_dim.setdefault(p.dim % t.ndim, []).append(i)
    gather, j = set(), 0
    for d, size in enumerate(t.shape):
        prod, first = 1, None
        while j < len(shape) and prod < size:
            if first is None:
                first = shape[j]
            prod *= shape[j]
            j += 1
        if d in by_dim and first is not None and first != size:
            count = 1
            for i in by_dim[d]:
                count *= t.device_mesh.size(i)
            if first % count:
                gather.update(by_dim[d])
    return gather


def build_step(cfg, shape, rt):
    if shape.kind == "train":
        return make_train_step(cfg, rt, sp.default_optimizer())
    if shape.kind == "prefill":
        return make_serve_prefill(cfg, rt)
    return make_serve_step(cfg, rt)


def build_shardings(cfg, shape, rt, mesh, abstract_args,
                    dp_only: bool = False):
    """The placements of the step's inputs (the reference's
    ``in_shardings``).  dp_only (§Perf): the batch sharded over every
    mesh axis, the params' specs at ``model_size=1``, as the reference
    passes it."""
    model_size = 1 if dp_only else None
    if shape.kind == "train":
        params, opt_state, batch = abstract_args
        p_sh = shd.partition_params(params, cfg, mesh, model_size)
        o_sh = AdamWState(step=shd.replicated(mesh), mu=p_sh, nu=p_sh)
        return (p_sh, o_sh, shd.partition_batch(batch, mesh, dp_only))
    if shape.kind == "prefill":
        params, batch = abstract_args
        return (shd.partition_params(params, cfg, mesh, model_size),
                shd.partition_batch(batch, mesh, dp_only))
    params, cache, token = abstract_args
    return (shd.partition_params(params, cfg, mesh, model_size),
            shd.partition_cache(cache, mesh, shape.global_batch, dp_only),
            shd.batch_input_sharding(mesh, shape.global_batch, 1,
                                     dp_only))


def _distribute(abstract_args, in_sh, mesh):
    out = []
    for a, s in zip(abstract_args, in_sh):
        if isinstance(a, AdamWState):
            out.append(AdamWState(*(shd.shard_tree(x, p, mesh)
                                    for x, p in zip(a, s))))
        else:
            out.append(shd.shard_tree(a, s, mesh))
    return tuple(out)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               verbose: bool = True, absorbed_mla: bool = False,
               unroll: bool = False, dp_only: bool = False,
               rt_overrides: Optional[Dict] = None) -> Dict:
    """One (arch, shape, mesh) combination; returns its record.  Makes
    the fake group (and tears it down after) unless one exists."""
    from torch.distributed import is_initialized

    owns_group = not is_initialized()
    mesh = make_production_mesh(multi_pod=multi_pod)
    # the RoPE frequencies are cached a device: keep the step's fake
    # ones out of the cache the served paths read, and theirs out of it
    layers._rope_freqs.cache_clear()
    try:
        cfg = get_config(arch)
        shape = get_shape(shape_name)
        rt = sp.runtime_for(cfg, shape, model_axis_size(mesh),
                            absorbed_mla=absorbed_mla)
        if unroll:
            rt = dataclasses.replace(rt, scan_unroll=True)
        if rt_overrides:
            rt = dataclasses.replace(rt, **rt_overrides)
        if rt.moe_impl == "shard_map":
            rt = dataclasses.replace(rt, mesh=mesh)
        t0 = time.time()
        abstract_args = sp.input_specs(cfg, shape, rt)
        mode = _tensors(abstract_args)[0].fake_mode
        step = build_step(cfg, shape, rt)
        in_sh = build_shardings(cfg, shape, rt, mesh, abstract_args,
                                dp_only)
        with mode:
            args = _distribute(abstract_args, in_sh, mesh)
            t_lower = time.time() - t0
            counter, reshard = StepCounter(), Reshard()
            counter.track([t.to_local() if isinstance(t, DTensor) else t
                           for t in _tensors(args)])
            t0 = time.time()
            with implicit_replication(), reshard, counter:
                out = step(*args)
            t_run = time.time() - t0
            peak = counter.peak_bytes
        arg_bytes = _local_bytes(args)
        coll = counter.collective_bytes
        rec = {
            "arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_devices": 512 if multi_pod else 256,
            "kind": shape.kind,
            "flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes_accessed),
            "collective_bytes": coll,
            "collective_total": float(sum(coll.values())),
            "collective_elements": counter.collective_elements,
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": max(peak - arg_bytes, 0),
            "peak_bytes": peak,
            "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "kv_mult": rt.kv_mult, "window": rt.window,
            "moe_impl": rt.moe_impl,
            "reshards": reshard.sites,
        }
    finally:
        layers._rope_freqs.cache_clear()
        if owns_group:
            teardown()
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: OK  "
              f"flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
              f"coll={rec['collective_total']:.3e} "
              f"(build {t_lower:.1f}s run {t_run:.1f}s)")
        print(f"  memory: args={rec['argument_bytes']:.3e} "
              f"out={rec['output_bytes']:.3e} temp={rec['temp_bytes']:.3e} "
              f"peak={rec['peak_bytes']:.3e}; reshards {rec['reshards']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--absorbed-mla", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(dryrun_one(
                        arch, shape, mp, absorbed_mla=args.absorbed_mla))
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures.append((arch, shape, mp, repr(e)[:500]))
                    print(f"[dryrun] {arch} x {shape} x "
                          f"{'2x16x16' if mp else '16x16'}: FAIL {e!r}",
                          file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results,
                       "failures": [list(f_) for f_ in failures]}, f,
                      indent=1)
    print(f"[dryrun] {len(results)} OK, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
