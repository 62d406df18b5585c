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
``training=False``.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .layers.core import InputLayer
from .module import Layer, resolve_device

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


def _slot_key(i: int, layer: Layer) -> str:
    return f"{i}_{type(layer).__name__.lower()}"


class GraphModule(Layer):
    """DAG of layers between ``inputs`` and ``outputs`` nodes."""

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

    @property
    def output_shape(self):
        shapes = [n.shape for n in self.output_nodes]
        return shapes[0] if self.single_output else shapes

    def apply(self, x):
        xs = [x] if self.single_input else list(x)
        if len(xs) != len(self.input_nodes):
            raise ValueError(f"expected {len(self.input_nodes)} inputs, got "
                             f"{len(xs)}")
        values: Dict[int, Any] = {n.uid: v
                                  for n, v in zip(self.input_nodes, xs)}
        for node in self.nodes:
            if node.uid in values:
                continue
            inp = (values[node.inbound[0].uid] if len(node.inbound) == 1
                   else [values[p.uid] for p in node.inbound])
            values[node.uid] = node.layer(inp)
        outs = [values[n.uid] for n in self.output_nodes]
        return outs[0] if self.single_output else outs

    def compute_output_shape(self, input_shape):
        return self.output_shape


class SequentialModule(Layer):
    """Linear stack of layers; the first needs ``input_shape=``. Layers are
    built as they are added."""

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

    def apply(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for l in self.layers:
            shape = l.compute_output_shape(shape)
        return shape


__all__ = ["GraphModule", "Input", "Node", "SequentialModule", "apply_layer"]
