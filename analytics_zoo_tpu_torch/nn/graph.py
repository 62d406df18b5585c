"""Functional graph API: ``Input`` nodes, the DAG ``GraphModule`` and
``SequentialModule`` (port of ``analytics_zoo_tpu/nn/graph.py``).

``layer(node)`` connects layers as in the JAX package, so a model reads the
same in both (``x = L.Dense(10)(Input((4,)))``). The graph is a build-time
structure: ``apply`` walks the nodes in topological order. Every unique
layer is registered under its deterministic positional slot,
``f"{i}_{type(layer).__name__.lower()}"`` — the JAX param tree's key — so
the state dict reads ``12_convolution2d.kernel``,
``13_batchnormalization.moving_mean`` and loads a JAX model's params and
state through :func:`analytics_zoo_tpu_torch.bridge.state_dict_from_jax`.

A container builds its layers' parameters when it is made, on the CPU from
``torch.Generator().manual_seed(seed)`` in slot order (the draws do not
reproduce JAX's), then moves them to ``device``: CUDA unless the caller
names another, and with no CUDA and no device it raises. Containers start
in inference mode (``eval()``), as JAX's ``apply`` defaults to
``training=False``. ``apply(x, rng=key)`` splits the key as the JAX
containers do (a graph into one key a node, a Sequential into one a
layer) and hands each layer that draws randomness its own
(``Layer.takes_rng``: ``Dropout``, nested containers).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .layers.core import InputLayer
from .module import (Layer, call_layer, draws_rng, resolve_device,
                     split_rng)

_UIDS = itertools.count(1)


class Node:
    """One tensor in the DAG: produced by ``layer`` applied to ``inbound``
    nodes; ``shape`` excludes the batch dim."""

    def __init__(self, layer: Layer, inbound: List["Node"], shape):
        self.layer = layer
        self.inbound = inbound
        self.shape = tuple(shape)
        self.uid = next(_UIDS)

    def __repr__(self):
        return f"Node({self.layer.name}, shape={self.shape})"


def Input(shape, name: Optional[str] = None) -> Node:
    """A graph input; ``shape`` excludes the batch dim."""
    return Node(InputLayer(tuple(shape), name=name), [], tuple(shape))


def apply_layer(layer: Layer, node_or_nodes) -> Node:
    if isinstance(node_or_nodes, (list, tuple)):
        nodes = list(node_or_nodes)
        return Node(layer, nodes,
                    layer.compute_output_shape([n.shape for n in nodes]))
    return Node(layer, [node_or_nodes],
                layer.compute_output_shape(node_or_nodes.shape))


def _topo_order(outputs: Sequence[Node]) -> List[Node]:
    order: List[Node] = []
    seen = set()

    def visit(n: Node):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for p in n.inbound:
            visit(p)
        order.append(n)

    for o in outputs:
        visit(o)
    return order


def _sum_regularization(layers):
    total = 0.0
    for layer in layers:
        reg = getattr(layer, "regularization", None)
        if reg is not None:
            total = total + reg()
    return total


def _slot_key(i: int, layer: Layer) -> str:
    return f"{i}_{type(layer).__name__.lower()}"


class GraphModule(Layer):
    """DAG of layers between ``inputs`` and ``outputs`` nodes."""

    takes_rng = True

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]],
                 name: Optional[str] = None, *, device=None, seed: int = 0):
        super().__init__(name=name)
        dev = resolve_device(device)
        self.input_nodes = [inputs] if isinstance(inputs, Node) \
            else list(inputs)
        self.output_nodes = [outputs] if isinstance(outputs, Node) \
            else list(outputs)
        self.single_input = isinstance(inputs, Node)
        self.single_output = isinstance(outputs, Node)
        self.nodes = _topo_order(self.output_nodes)
        # each node's value is dropped after its last consumer, so a
        # forward holds the live activations (as a compiled program does),
        # not every one it made
        last_use: Dict[int, int] = {}
        for i, n in enumerate(self.nodes):
            for p in n.inbound:
                last_use[p.uid] = i
        outputs = {n.uid for n in self.output_nodes}
        self._drop_after: Dict[int, List[int]] = {}
        for uid, i in last_use.items():
            if uid not in outputs:
                self._drop_after.setdefault(i, []).append(uid)
        for n in self.nodes:
            if isinstance(n.layer, InputLayer) and n not in self.input_nodes:
                raise ValueError(f"graph uses Input node {n} not listed in "
                                 f"inputs")
        # one entry per unique layer (a layer at several nodes shares its
        # weights), keyed by position as in the JAX package
        self.layers: List[Layer] = []
        first: Dict[int, Node] = {}
        for n in self.nodes:
            if id(n.layer) not in first and not isinstance(n.layer,
                                                           InputLayer):
                first[id(n.layer)] = n
                self.layers.append(n.layer)
        self._slots = {id(l): _slot_key(i, l)
                       for i, l in enumerate(self.layers)}
        gen = torch.Generator().manual_seed(seed)
        for layer in self.layers:
            node = first[id(layer)]
            if not layer.built:
                in_shape = (node.inbound[0].shape if len(node.inbound) == 1
                            else [p.shape for p in node.inbound])
                layer.build(in_shape, gen)
                layer.built = True
            self.add_module(self.slot(layer), layer)
        self.built = True
        self.device = dev
        self.to(dev)
        self.eval()

    def slot(self, layer: Layer) -> str:
        return self._slots[id(layer)]

    def regularization(self):
        """The sum of the layers' regularization terms (0.0 without
        regularizers): the training loss's penalty."""
        return _sum_regularization(self.layers)

    @property
    def output_shape(self):
        shapes = [n.shape for n in self.output_nodes]
        return shapes[0] if self.single_output else shapes

    def apply(self, x, rng=None):
        xs = [x] if self.single_input else list(x)
        if len(xs) != len(self.input_nodes):
            raise ValueError(f"expected {len(self.input_nodes)} inputs, got "
                             f"{len(xs)}")
        values: Dict[int, Any] = {n.uid: v
                                  for n, v in zip(self.input_nodes, xs)}
        rngs = iter(split_rng(rng if draws_rng(self) else None,
                              len(self.nodes)))
        for i, node in enumerate(self.nodes):
            if node.uid not in values:
                inp = (values[node.inbound[0].uid] if len(node.inbound) == 1
                       else [values[p.uid] for p in node.inbound])
                values[node.uid] = call_layer(node.layer, inp, next(rngs))
            for uid in self._drop_after.get(i, ()):
                del values[uid]
        outs = [values[n.uid] for n in self.output_nodes]
        return outs[0] if self.single_output else outs

    def compute_output_shape(self, input_shape):
        return self.output_shape


class SequentialModule(Layer):
    """Linear stack of layers; the first needs ``input_shape=``. Layers are
    built as they are added."""

    takes_rng = True

    def __init__(self, layers: Optional[Sequence[Layer]] = None, name=None,
                 *, device=None, seed: int = 0):
        super().__init__(name=name)
        self.device = resolve_device(device)
        self.layers: List[Layer] = []
        self._gen = torch.Generator().manual_seed(seed)
        self._shape = None
        for layer in layers or ():
            self.add(layer)
        self.eval()

    def add(self, layer: Layer) -> "SequentialModule":
        shape = self._shape if self.layers else layer.input_shape_hint
        if shape is None:
            raise ValueError("Sequential: first layer needs input_shape=...")
        if not layer.built:
            layer.build(shape, self._gen)
            layer.built = True
        self.add_module(_slot_key(len(self.layers), layer),
                        layer.to(self.device))
        self.layers.append(layer)
        self._shape = tuple(layer.compute_output_shape(shape))
        self.built = True
        return self

    def slot(self, layer: Layer) -> str:
        hits = [i for i, l in enumerate(self.layers) if l is layer]
        if len(hits) != 1:
            raise ValueError(
                f"layer {layer.name} appears {len(hits)} times in this "
                "Sequential; address its params by position instead")
        return _slot_key(hits[0], layer)

    def regularization(self):
        return _sum_regularization(self.layers)

    def apply(self, x, rng=None):
        keys = split_rng(rng if draws_rng(self) else None, len(self.layers))
        for layer, key in zip(self.layers, keys):
            x = call_layer(layer, x, key)
        return x

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for l in self.layers:
            shape = l.compute_output_shape(shape)
        return shape


__all__ = ["GraphModule", "Input", "Node", "SequentialModule", "apply_layer"]
