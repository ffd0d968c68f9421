"""Driver: a training step of an FSWConv (or FSW-GNN) of the program,
written out here as the repository's headline writes it (forward,
`loss.backward()`, the optimizer's step), on one layout of the graph,
captured once as a CUDA graph and replayed (eagerly on the CPU).

Set-up builds one model and one optimizer and keeps them: on the card the
first eager step runs on a side stream (it makes the gradients' buffers and
loads every kernel), the step is captured, the parameters go back to their
initial values, and the first `checked_steps` steps of the window's own
call (a replay) are the checked ones: their losses, the first one's
output and gradients (the captured buffers, copied after the replay) and
the leaves' change after the last.  Set-up then replays on until
`settle_s` seconds have passed since the capture, and the window replays
on from there.

The settle: on the H100 a freshly captured graph of this step replays
slower (wider gaps between its kernels, the kernels' own times unchanged:
3.5% on degree classes, 1% on the CSR graph) for a time after its
capture that varies from run to run, and then stays fast.  The time
passes whether the graph replays or not, and a second capture starts it
again; so the window starts a fixed time after the capture, and set-up
takes the same time in every run.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from ..gen import trainable


def build_model(model: dict, device):
    """The program's model of the configuration, its leaves to be loaded
    (the benchmark draws them itself, so the slices' coherence minimizer,
    which only shapes the draw, is off)."""
    from fsw_gnn_tpu_torch import FSWGNN, FSWConv
    if model['dtype'] != 'float32' or model['minimize_slice_coherence']:
        raise ValueError('the drivers run float32 models with leaves drawn '
                         'by the benchmark')
    if model['kind'] == 'fsw_conv':
        return FSWConv(model['in_channels'], model['out_channels'],
                       mlp_layers=model['mlp_layers'],
                       minimize_slice_coherence=False, device=device)
    return FSWGNN(model['in_channels'],
                  tuple(model['hidden_dims']) + (model['num_classes'],),
                  mlp_layers=model['mlp_layers'],
                  minimize_slice_coherence=False, device=device)


def layout(edge_index, num_nodes: int, name: str, device):
    """The program's layout of the graph: 'multi' (degree classes),
    'table' (one neighbour table) or 'csr'."""
    from fsw_gnn_tpu_torch import (from_edge_index, to_multi_table,
                                   to_neighbor_table)
    g = from_edge_index(edge_index, num_nodes)
    if name == 'multi':
        g = to_multi_table(g)
    elif name == 'table':
        g = to_neighbor_table(g)
    elif name != 'csr':
        raise ValueError(f'unknown layout {name!r}')
    return g.to(device)


def sum_sq_over_nodes(out):
    """bench.py's sum of squares, over the nodes (the port's bench.py
    divides by N: the plain sum diverges under SGD(1e-3))."""
    return (out * out).sum() / out.shape[0]


class Cell:
    def __init__(self, cfg: dict, wl: dict, inputs: dict, device):
        train = cfg['train']
        if train['optimizer'] != 'sgd' or train['loss'] != 'sum_sq_over_nodes':
            raise ValueError('conv_step replays SGD (no optimizer state to '
                             'restore after the capture) on sum_sq_over_nodes')
        g = layout(inputs['edge_index'], inputs['num_nodes'], wl['layout'],
                   device)
        X = inputs['X']
        model = build_model(cfg['model'], device)
        model.load_state_dict(inputs['params'], strict=True)
        params = dict(model.named_parameters())
        opt = torch.optim.SGD(list(params.values()), lr=float(train['lr']))

        outs = []

        def step():
            # zeroed in place: the captured step accumulates into them
            opt.zero_grad(set_to_none=False)
            out = model(X, g)
            outs[:] = [out.detach()]         # no copy: the graph's buffer
            value = sum_sq_over_nodes(out)
            value.backward()
            opt.step()
            return value.detach()

        self.model, self.params = model, params
        self.steps_per_call = int(wl['steps_per_call'])
        if device.type == 'cuda':
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a collection inside the capture may free an older graph,
            # which invalidates the capture in progress
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=side):
                    self.loss_out = step()
            finally:
                gc.enable()
            captured = time.perf_counter()
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(inputs['params'][k])
            self._one = graph.replay
        else:
            def eager():
                self.loss_out = step()
            self._one = eager

        # the checked steps: the window's own call, from the seed's leaves
        losses, grad, first_out = [], None, None
        for _ in range(int(wl['checked_steps'])):
            self._one()
            losses.append(self.loss_out.clone())
            if grad is None:
                first_out = outs[0].clone()
                grad = {k: p.grad.detach().clone() for k, p in params.items()
                        if trainable(k)}
        self.first = {
            'losses': losses, 'out': first_out, 'grad': grad,
            'change': {k: p.detach() - inputs['params'][k]
                       for k, p in params.items() if trainable(k)}}
        if device.type == 'cuda':
            ms = self._settle(captured + float(wl.get('settle_s', 0.0)))
            print('conv_step: ms a replay in the settle, about every 2 s: '
                  + str(ms), file=sys.stderr)

    def _settle(self, until: float) -> list:
        """Calls of the window's kind until `until` (perf_counter); the
        ms a replay of a call about every 2 s, by CUDA events."""
        marks, last = [], None
        while time.perf_counter() < until:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self.call()
            b.record()
            b.synchronize()
            if last is None or time.perf_counter() - last >= 2.0:
                marks.append(round(a.elapsed_time(b) / self.steps_per_call,
                                   4))
                last = time.perf_counter()
        return marks

    def call(self) -> int:
        """One call of the window: `steps_per_call` steps; returns them."""
        for _ in range(self.steps_per_call):
            self._one()
        return self.steps_per_call

    def leaves(self):
        return list(self.params.values())
