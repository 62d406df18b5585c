"""Weight bridge between the JAX package's param trees and the port's
modules.

The port names every parameter after its path in the JAX tree
(``block0.attn.qkv_kernel`` is ``params["block0"]["attn"]["qkv_kernel"]``)
and keeps the JAX (in, out) layout, so the bridge is a lossless rename:

    tree = jax.tree_util.tree_map(np.asarray, params)   # in the JAX process
    model.load_state_dict(params_from_jax(tree, device=model.device))

A graph model's params and state trees (BatchNormalization's
``moving_mean``/``moving_var`` live in the state tree in JAX and are
buffers in the port) share their slot keys (``12_convolution2d``,
``13_batchnormalization``); :func:`state_dict_from_jax` merges the two:

    model.load_state_dict(state_dict_from_jax(params, state))

bf16 leaves (numpy arrays of ``ml_dtypes.bfloat16``) cross as their raw
16-bit patterns, so no value is rounded either way.

The Estimator's whole training state crosses the same way, as the JAX
package's train-state tree ``{"params", "opt_state", "model_state",
"step", "rng"}`` (:func:`train_state_to_jax`, :func:`train_state_from_jax`):
the module's parameters and persistent buffers (BN statistics, the JAX
``model_state``) nested by their dotted names, the optimizer state as
optax's NamedTuples with its per-parameter dicts nested the same way and
its host counts as 0-d int32, ``step`` as a 0-d int32 and the training
key as the (2,) uint32 array ``jax.random.split`` gives. Flattened in
JAX's order (``engine/checkpoint.py``), its leaves and their paths are
those of a checkpoint the JAX Estimator writes for the same model and
optimizer.

A hot swap lands new weights by reference: :func:`stage_tensors` copies
them to the device on a side stream before the flip, and
:func:`land_tensors` makes the serving stream wait for that copy at the
flip, so the flip itself copies nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.astype(np.int16, copy=True)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree: Mapping[str, Any], *, device="cpu"
                    ) -> Dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays (a JAX param tree after
    ``tree_map(np.asarray, ...)``) into a state dict of tensors on
    ``device``, keyed by the dotted tree path, dtypes unchanged."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        else:
            out[prefix[:-1]] = _to_tensor(node).to(device)

    walk(tree, "")
    return out


def state_dict_from_jax(params: Mapping[str, Any],
                        state: Mapping[str, Any] = None, *, device="cpu"
                        ) -> Dict[str, torch.Tensor]:
    """One state dict from a JAX model's params tree and its state tree
    (numpy leaves, as in :func:`params_from_jax`); a key in both raises."""
    out = params_from_jax(params, device=device)
    for k, v in params_from_jax(state or {}, device=device).items():
        if k in out:
            raise ValueError(f"{k} is in both the params and the state tree")
        out[k] = v
    return out


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse: the module's parameters as a nested dict of numpy
    arrays in the JAX tree's shape. bf16 parameters come back as
    ``ml_dtypes.bfloat16`` arrays (imported only then)."""
    flat: Dict[str, Any] = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            flat[name] = t.view(torch.int16).numpy().view(np.uint16).view(
                ml_dtypes.bfloat16)
        else:
            flat[name] = t.numpy().copy()
    return nest(flat)


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """A dict keyed by dotted names as the nested dict of the JAX tree."""
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _lookup(tree: Mapping[str, Any], name: str):
    for p in name.split("."):
        tree = tree[p]
    return tree


def opt_state_to_jax(state):
    """The port's optimizer state in optax's shape: NamedTuples and tuples
    kept, per-parameter dicts nested, host counts as 0-d int32 arrays."""
    if state is None:
        return None
    if isinstance(state, dict):
        return nest(state)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(opt_state_to_jax(v) for v in state))
    if isinstance(state, (tuple, list)):
        return tuple(opt_state_to_jax(v) for v in state)
    if isinstance(state, int):
        return np.asarray(state, np.int32)
    return state


def opt_state_from_jax(tree, like):
    """The inverse of :func:`opt_state_to_jax` in the structure of the
    port's state ``like``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {n: opt_state_from_jax(_lookup(tree, n), v)
                for n, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(opt_state_from_jax(getattr(tree, f), v)
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(opt_state_from_jax(t, v)
                          for t, v in zip(tree, like))
    if isinstance(like, int):
        return int(np.asarray(tree))
    return tree


def model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The persistent buffers of ``model`` by name: the JAX ``model_state``
    (BatchNormalization's moving statistics, an int8 layer's packing)."""
    names = {n for n, _ in model.named_parameters()}
    return {n: t for n, t in model.state_dict(keep_vars=True).items()
            if n not in names}


def train_state_to_jax(model: torch.nn.Module,
                       train_state: Mapping[str, Any], *,
                       params: Mapping[str, torch.Tensor] = None,
                       opt_is_jax: bool = False) -> Dict[str, Any]:
    """The JAX Estimator's train-state tree over the port's live tensors
    (no copies): what ``engine/checkpoint.py`` saves. ``params``: the
    parameters' whole values where the module holds a rank's blocks;
    ``opt_is_jax``: the optimizer state is already in the JAX shape."""
    if params is None:
        params = {n: p.detach() for n, p in model.named_parameters()}
    opt = train_state["opt_state"]
    return {
        "params": nest(dict(params)),
        "opt_state": opt if opt_is_jax else opt_state_to_jax(opt),
        "model_state": nest({n: b.detach()
                             for n, b in model_state(model).items()}),
        "step": np.asarray(train_state["step"], np.int32),
        "rng": np.asarray(train_state["rng"], np.uint32),
    }


def train_state_from_jax(model: torch.nn.Module, tree: Mapping[str, Any],
                         like: Mapping[str, Any], *,
                         block=None) -> Dict[str, Any]:
    """Install a train-state tree (structured as :func:`train_state_to_jax`
    gives it, leaves on the model's device) into ``model`` in place, and
    return the Estimator's ``train_state`` in the structure of ``like``.
    ``block(name, whole)``: a rank's block of a parameter it holds
    sharded."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            whole = _lookup(tree["params"], n)
            p.copy_(block(n, whole) if block is not None else whole)
        for n, b in model_state(model).items():
            b.copy_(_lookup(tree["model_state"], n))
    rng = np.asarray(tree["rng"]).reshape(-1).tolist()
    return {"opt_state": opt_state_from_jax(tree["opt_state"],
                                            like["opt_state"]),
            "step": int(np.asarray(tree["step"])),
            "rng": (int(rng[0]), int(rng[1]))}


def map_param_dicts(state, fn):
    """``state`` (an optimizer state of the port) with each per-parameter
    dict's entries replaced by ``fn(name, tensor)``: how a rank's blocks
    of a sharded state cross to whole leaves and back."""
    if isinstance(state, dict):
        return {n: fn(n, v) if isinstance(v, torch.Tensor) else v
                for n, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(map_param_dicts(v, fn) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(map_param_dicts(v, fn) for v in state)
    return state


def _is_flat_dict(s) -> bool:
    from .parallel.update_sharding import FLAT

    return isinstance(s, dict) and set(s) == {FLAT}


def flat_opt_state_to_jax(state, gather):
    """A rank's flat-update state (``FlatUpdateState`` over ``{FLAT:
    shard}``) as the JAX package's ``FlatUpdateState`` over (npad,)
    vectors: ``gather(shard)`` makes each whole vector (every rank calls
    it)."""
    from .parallel.update_sharding import FLAT, FlatUpdateState

    def walk(s):
        if _is_flat_dict(s):
            return gather(s[FLAT])
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(*(walk(v) for v in s))
        if isinstance(s, (tuple, list)):
            return tuple(walk(v) for v in s)
        if isinstance(s, int):
            return np.asarray(s, np.int32)
        return s

    return FlatUpdateState(walk(state.inner_state),
                           None if state.master is None
                           else gather(state.master))


def flat_opt_state_from_jax(tree, like, take):
    """The inverse of :func:`flat_opt_state_to_jax` in the structure of the
    rank's state ``like``: ``take(vector)`` is the rank's shard."""
    from .parallel.update_sharding import FLAT, FlatUpdateState

    def walk(t, s):
        if _is_flat_dict(s):
            return {FLAT: take(t)}
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(*(walk(getattr(t, f), v)
                             for f, v in zip(s._fields, s)))
        if isinstance(s, (tuple, list)):
            return type(s)(walk(a, v) for a, v in zip(t, s))
        if isinstance(s, int):
            return int(np.asarray(t))
        return s if s is None else t

    return FlatUpdateState(walk(tree.inner_state, like.inner_state),
                           None if like.master is None
                           else take(tree.master))


def flat_tree(params) -> Dict[str, torch.Tensor]:
    """A param tree as ``{dotted name: tensor}``: the port's own form (a
    state dict of tensors) as it is, a JAX-layout tree of numpy arrays
    through :func:`params_from_jax`."""
    if isinstance(params, Mapping) and params and all(
            isinstance(v, torch.Tensor) for v in params.values()):
        return dict(params)
    return params_from_jax(params)


def stage_tensors(tensors: Mapping[str, torch.Tensor], device,
                  make: Any = None):
    """Fresh copies of ``tensors`` on ``device``, made off the serving
    stream: ``(staged, ready)``. On the card the copies (and
    ``make(staged)``, which may add entries computed from them) run on a
    side stream that first waits for the caller's stream, and ``ready`` is
    the side stream's event; on the CPU ``ready`` is None."""
    device = torch.device(device)
    if device.type != "cuda":
        staged = {n: t.detach().to(device, copy=True)
                  for n, t in tensors.items()}
        if make is not None:
            make(staged)
        return staged, None
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        staged = {n: t.detach().to(device, copy=True, non_blocking=True)
                  for n, t in tensors.items()}
        if make is not None:
            make(staged)
        ready = torch.cuda.Event()
        ready.record(side)
    return staged, ready


def land_tensors(staged: Mapping[str, torch.Tensor], ready, device) -> None:
    """Make the current stream wait for a :func:`stage_tensors` copy and
    hand the staged tensors to it (``record_stream``: the allocator must
    not give their blocks back to the side stream while this stream reads
    them)."""
    if ready is None:
        return
    stream = torch.cuda.current_stream(torch.device(device))
    stream.wait_event(ready)
    for t in staged.values():
        t.record_stream(stream)


__all__ = ["flat_opt_state_from_jax", "flat_opt_state_to_jax",
           "map_param_dicts", "flat_tree", "model_state", "land_tensors", "nest", "opt_state_from_jax", "stage_tensors", "opt_state_to_jax",
           "params_from_jax", "params_to_numpy", "state_dict_from_jax",
           "train_state_from_jax", "train_state_to_jax"]
