"""The train, eval, distillation and DANN steps.

Port of ``multimodal_segmentation_project_tpu/engine/steps.py``'s
``make_train_step``, ``make_eval_step``, ``make_distill_step`` and
``make_dann_step``. A train step: optional augmentation, the train-mode
forward, the loss, the backward, the metrics on the device, and the masked
AdamW update of ``engine.state.TrainState``. Every parameter's gradient is
computed, the frozen ones' too (``TrainState.apply_gradients`` drops them
before AdamW), as the JAX package computes every gradient and masks the
updates.

The NaN guard skips a step whose gradients are not all finite, frozen
parameters' included, and leaves the whole state as it was before the
step: params, both Adam moments and the step counts (no update is
applied), the accumulator and its counter (nothing is folded in), and the
BatchNorm running statistics (the forward's update is undone). That is
what the JAX package's rollback leaves. The check reads one flag on the
host per step. The step's losses then read 0 and ``nonfinite`` 1.

Under a profiler a step's host time lies in flat spans (``utils/spans.py``):
``step.augment``, ``step.forward`` (the teacher's forward in one of its
own), ``step.backward``, ``step.update`` (the metrics and the guard's
launches), ``step.sync`` (the guard's read: the host blocked on the
device) and ``step.update`` again (the rollback or the optimizer).

On one CUDA device the train and DANN steps replay their device work as
a CUDA graph (:class:`_Replay`), from the BatchNorm save through the
guard's flag: the same function the eager step runs (``_supervised_body``,
``_dann_body``), on static inputs, with the Dropout masks drawn ahead by
the host from the step's generators. The augmentation, the guard's read,
the rollback and the update (the accumulator's fold and AdamW) stay
eager. A replayed step's spans: ``step.augment``, ``step.forward`` (the
masks' draw and the copies into the static inputs), ``step.replay`` (the
graph's launch alone), ``step.update``, ``step.sync`` and
``step.update``. The distillation step (its loss closes over the
teacher's logits of the step), the eval steps and every step on a
multi-device mesh run eagerly.

Each step's backward runs inside ``library_precision(model.dtype)``, the
scope the model's forward runs its library calls in: in an fp32 step
cuDNN's backward of the deep region's convs and of the fp32 transpose
convs runs with TF32 off, as the forward does, and the flag reads as
before once the backward returns. A bf16 step leaves it alone.

On a multi-device mesh (``parallel/mesh.py``) every rank runs the step on
its shard of the global batch. The losses and metrics are the global
batch's on every rank (their sums all-reduce, and so do their cotangents),
so each rank's backward gives the gradient of world * L; the gradients are
all-reduced over the mesh as one flat buffer and divided by its size right
after the backward, before the NaN guard, which then decides the same way
on every rank. A step with augmentation takes the global batch, which
every rank augments whole (flips cross the shards, as the JAX package
augments the global array) before it takes its own slice; the other steps
take this rank's slice. :func:`make_sharded_eval_step` evaluates
``n_data`` distinct volumes a step.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from collections import OrderedDict

import torch
import torch.nn.modules.module as nn_module

from multimodal_segmentation_project_tpu_torch.models.unet3d import (
    MaskSource,
    draw_masks,
    library_precision,
)
from multimodal_segmentation_project_tpu_torch.ops.augment import augment_batch
from multimodal_segmentation_project_tpu_torch.ops.grl import grad_reverse
from multimodal_segmentation_project_tpu_torch.ops.losses import cross_entropy_loss
from multimodal_segmentation_project_tpu_torch.ops.metrics import (
    segmentation_metrics,
    segmentation_metrics_per_sample,
)
from multimodal_segmentation_project_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    active_multi_mesh,
    all_reduce_,
    data_rows,
    reduce_sum,
    reduction_axis,
    shard_batch_arrays,
)
from multimodal_segmentation_project_tpu_torch.utils.spans import span


def _bn_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    return [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var",
                                                               "num_batches_tracked"))]


def _zero_grads(*models: torch.nn.Module) -> None:
    for model in models:
        for p in model.parameters():
            p.grad = None


def _backward(loss: torch.Tensor, model: torch.nn.Module, *others: torch.nn.Module) -> None:
    """loss.backward() in the model's library-precision scope (cuDNN's TF32
    off in an fp32 model's backward), then, on a multi-device mesh, the
    gradients of ``model`` and ``others`` summed over the mesh in one flat
    buffer and divided by its size."""
    with span("step.backward"):
        with library_precision(model.dtype):
            loss.backward()
        mesh = active_multi_mesh()
        if mesh is None:
            return
        grads = [p.grad for m in (model, *others) for p in m.parameters() if p.grad is not None]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh.group)
        flat /= mesh.size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _augment_and_shard(generator, images, labels):
    """The global batch augmented whole, then this rank's slice of it on a
    multi-device mesh."""
    with span("step.augment"):
        images, labels = augment_batch(generator, images, labels)
        mesh = active_multi_mesh()
        if mesh is not None:
            images, labels = shard_batch_arrays(mesh, images, labels)
    return images, labels


def _finite_flag(models: tuple) -> torch.Tensor:
    """The NaN guard's flag on the device: whether every gradient of
    ``models`` is finite."""
    grads = [p.grad for m in models for p in m.parameters() if p.grad is not None]
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def _guard(metrics: dict, states: tuple, flag, saved: list, loss_keys: tuple) -> dict:
    """The end of a step, after its metrics: with the NaN guard's ``flag``
    (None without the guard) the host reads it, which is the one wait on
    the device a step (``step.sync``), and sets ``metrics['nonfinite']``.
    A step whose gradients are not all finite zeroes the losses
    ``loss_keys``, restores the first model's BatchNorm buffers from
    ``saved`` and drops every gradient; any other updates each state."""
    finite = True
    if flag is not None:
        with span("step.sync"):
            finite = bool(flag)
    models = tuple(st.model for st in states)
    with span("step.update"):
        if flag is not None:
            metrics["nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=flag.device)
        if not finite:
            for k in loss_keys:
                metrics[k] = torch.zeros((), device=flag.device)
            with torch.no_grad():
                for b, old in zip(_bn_buffers(models[0]), saved):
                    b.copy_(old)
            _zero_grads(*models)
            return metrics
        for st in states:
            st.apply_gradients()
    return metrics


def _eager(body, states: tuple, inputs: tuple, sources, loss_keys: tuple) -> dict:
    """``body``'s step run eagerly, then the guard and the update."""
    metrics, flag, saved = body(tuple(st.model for st in states), inputs, sources)
    return _guard(metrics, states, flag, saved, loss_keys)


def _supervised_body(loss_fn, nan_guard: bool):
    """The train and distillation steps' device work after their
    augmentation, ``body((model,), (images, labels), (masks,)) -> (metrics,
    flag, saved)``: the train-mode forward with its Dropout masks from
    ``masks`` (a generator or a ``MaskSource``), ``loss_fn(logits,
    labels)``, the backward, the metrics and the guard's flag."""

    def body(models, inputs, sources):
        (model,), (images, labels), (masks,) = models, inputs, sources
        with span("step.forward"):
            model.train()
            saved = [b.clone() for b in _bn_buffers(model)] if nan_guard else None
            _zero_grads(model)
            logits = model(images, generator=masks)
            loss = loss_fn(logits, labels)
        _backward(loss, model)
        with span("step.update"):
            metrics = segmentation_metrics(logits.detach(), labels)
            metrics["loss"] = loss.detach()
            flag = _finite_flag((model,)) if nan_guard else None
        return metrics, flag, saved

    return body


_GLOBAL_HOOKS = ("_global_forward_pre_hooks", "_global_forward_hooks",
                 "_global_backward_pre_hooks", "_global_backward_hooks")


def _hooks_replayable(model: torch.nn.Module) -> bool:
    """Whether a replay can stand for the model's forward and backward: it
    has no hooks but plain forward hooks of its own, which the step calls
    with each replay's outputs. A pre-hook, a hook that takes the kwargs, a
    backward hook, a submodule's hook or a global one would not run."""
    if any(getattr(nn_module, name, None) for name in _GLOBAL_HOOKS):
        return False
    if (model._forward_pre_hooks or model._forward_hooks_with_kwargs or model._backward_hooks
            or model._backward_pre_hooks):
        return False
    return not any(m._forward_pre_hooks or m._forward_hooks or m._backward_hooks
                   or m._backward_pre_hooks for m in model.modules() if m is not model)


def _replays(states: tuple, inputs: tuple, generators) -> bool:
    """Whether a step's device work may replay as a CUDA graph: its inputs
    on a CUDA device, no multi-device mesh, its generators on the CPU (or
    None, the CPU's default one) and hooks a replay can honour."""
    return (inputs[0].device.type == "cuda" and active_multi_mesh() is None
            and all(g is None or g.device.type == "cpu" for g in generators)
            and all(_hooks_replayable(st.model) for st in states))


def _identity(states: tuple) -> tuple:
    """What a capture holds on to of the states: each optimizer (a freeze
    or an unfreeze builds a fresh one), the compute dtype and the address
    of every parameter and buffer."""
    return tuple((st.optimizer, getattr(st.model, "dtype", None),
                  tuple(t.data_ptr() for t in itertools.chain(st.model.parameters(),
                                                               st.model.buffers())))
                 for st in states)


@contextlib.contextmanager
def _hooks_held(models: tuple):
    """Each model's forward hooks held aside while a capture runs its
    forward, and in their place one that notes each call's (module, args,
    output): the capture runs none of the caller's hooks, and the step
    calls them after each replay."""
    calls = []
    held = [m._forward_hooks for m in models]
    for m in models:
        m._forward_hooks = OrderedDict()
        m.register_forward_hook(lambda module, args, output: calls.append((module, args, output)))
    try:
        yield calls
    finally:
        for m, hooks in zip(models, held):
            m._forward_hooks = hooks


def _copied(metrics: dict) -> dict:
    """The metrics as views of one fresh stacked copy: the next replay
    overwrites the graph's, and the caller keeps them across steps."""
    values = torch.stack(list(metrics.values()))
    return dict(zip(metrics, values.unbind()))


class _Replay:
    """A one-card step whose device work replays as a CUDA graph.

    ``body(models, inputs, sources) -> (metrics, flag, saved)`` is the
    step's device work from the BatchNorm save through the NaN guard's flag,
    which the graph captures on static inputs, with a ``MaskSource`` handing
    out its Dropout masks from a static buffer (one per generator of the
    step, in ``sources``' order).

    A replayed step copies its inputs into the static ones, draws its masks
    from its generators as the forward would have (after the augmentation's
    draws) and copies them in with one non-blocking copy from pinned
    memory, launches the graph, copies the metrics out, calls each model's
    forward hooks with the replay's outputs, reads the flag and, if it is
    finite, updates each state eagerly (the accumulator's fold, AdamW where
    it is due); else it rolls the step back as the eager step does.

    The graph engages where :func:`_replays` holds; any other step runs
    ``body`` eagerly. The first two steps that engage run eagerly too: the
    first notes the masks' plan, the second runs on the capture's stream,
    where the capture finds what a step sets up lazily (cuBLAS's workspace
    of the stream). The third captures; no capture runs while a profiler
    records. A step whose inputs differ in shape or dtype from the
    capture's runs eagerly. A change of :func:`_identity` (a freeze or an
    unfreeze resets the optimizer) drops the graph, and the step captures
    anew. A replay's kernels run on the device alone: the kernel ops'
    launch counters (``ops.launch_counts``), which count launches from the
    host, count none of them, nor a capture's. ``replayed`` counts the steps
    that replayed, over every instance."""

    WARM_UP = 2
    replayed = 0

    def __init__(self, body, loss_keys: tuple):
        self.body, self.loss_keys = body, loss_keys
        self.warm = 0
        self.plans = self.signature = self.stream = None
        self._drop()

    def _drop(self) -> None:
        self.graph = self.key = self.out = self.calls = None
        self.inputs, self.masks, self.grads = None, None, None

    def __call__(self, states: tuple, inputs: tuple, generators) -> dict:
        if not _replays(states, inputs, generators):
            return _eager(self.body, states, inputs, generators, self.loss_keys)
        signature = [(t.shape, t.dtype) for t in inputs]
        key = _identity(states)
        if self.graph is not None and key != self.key:
            self._drop()
            _zero_grads(*(st.model for st in states))
        if self.graph is None:
            if (self.warm < self.WARM_UP or signature != self.signature
                    or torch.autograd.profiler._is_profiler_enabled):
                return self._warm_up(states, inputs, generators, signature)
            self._capture(states, inputs)
            self.key = key
        elif signature != self.signature:
            return _eager(self.body, states, inputs, generators, self.loss_keys)
        return self._replay(states, inputs, generators)

    def _warm_up(self, states, inputs, generators, signature) -> dict:
        """An eager step that notes the masks' plan; after the first, on the
        capture's stream."""
        sources = [MaskSource(g) for g in generators]
        if self.warm == 0:
            out = _eager(self.body, states, inputs, sources, self.loss_keys)
        else:
            stream, current = self._capture_stream(inputs[0].device), torch.cuda.current_stream()
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = _eager(self.body, states, inputs, sources, self.loss_keys)
            current.wait_stream(stream)
        self.warm += 1
        self.plans, self.signature = [src.plan for src in sources], signature
        return out

    def _capture_stream(self, device) -> torch.cuda.Stream:
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        return self.stream

    def _capture(self, states, inputs) -> None:
        models = tuple(st.model for st in states)
        stream = self._capture_stream(inputs[0].device)
        self.inputs = [torch.empty_like(t) for t in inputs]
        sizes = [sum(math.prod(shape) for shape, _ in plan) for plan in self.plans]
        self.masks = torch.empty(sum(sizes), dtype=torch.bool, device=inputs[0].device)
        sources = [MaskSource(buffer=b, plan=p) for b, p in zip(self.masks.split(sizes), self.plans)]
        self.graph = torch.cuda.CUDAGraph()
        with _hooks_held(models) as self.calls, torch.cuda.graph(self.graph, stream=stream):
            self.out = self.body(models, self.inputs, sources)
        if not all(src.exhausted() for src in sources):
            raise RuntimeError("the forward took fewer Dropout masks than its plan")
        self.grads = [(p, p.grad) for m in models for p in m.parameters() if p.grad is not None]

    def _replay(self, states, inputs, generators) -> dict:
        models = tuple(st.model for st in states)
        with span("step.forward"):
            for m in models:
                m.train()
            for static, t in zip(self.inputs, inputs):
                static.copy_(t)
            if self.masks.numel():
                drawn = torch.cat([draw_masks(p, g) for p, g in zip(self.plans, generators)])
                self.masks.copy_(drawn.pin_memory(), non_blocking=True)
        with span("step.replay"):
            self.graph.replay()
        _Replay.replayed += 1
        metrics, flag, saved = self.out
        with span("step.update"):
            metrics = _copied(metrics)
            for p, g in self.grads:
                p.grad = g
            for module, args, output in self.calls:
                for hook in tuple(module._forward_hooks.values()):
                    if hook(module, args, output) is not None:
                        raise RuntimeError(
                            "a forward hook returned a value: a replayed step cannot use it "
                            "in place of the model's output")
        return _guard(metrics, states, flag, saved, self.loss_keys)


def make_train_step(loss_fn, augment: bool = False, nan_guard: bool = False):
    """train_step(state, images, labels, generator) -> metrics (0-d tensors
    on the device: dice, iou, acc, loss, and nonfinite with the guard).
    ``generator`` draws the augmentation and the dropout masks; on a mesh it
    is the same on every rank. With ``augment`` on a mesh, ``images`` and
    ``labels`` are the global batch; else this rank's slice. On one CUDA
    device the step's device work replays as a CUDA graph (:class:`_Replay`)."""
    step = _Replay(_supervised_body(loss_fn, nan_guard), ("loss",))

    def train_step(state, images, labels, generator=None):
        if augment:  # rebinding frees the batch from before the augmentation
            images, labels = _augment_and_shard(generator, images, labels)
        return step((state,), (images, labels), (generator,))

    return train_step


def make_eval_step(loss_fn):
    """eval_step(state, images, labels) -> metrics of the eval forward."""

    @torch.no_grad()
    def eval_step(state, images, labels):
        model = state.model
        model.eval()
        logits = model(images)
        metrics = segmentation_metrics(logits, labels)
        metrics["loss"] = loss_fn(logits, labels)
        return metrics

    return eval_step


def make_sharded_eval_step(loss_fn):
    """eval_step(state, images, labels, weights) -> the weighted sums of the
    per-volume dice, iou, acc and loss, and ``n``, the sum of the weights.

    Port of ``engine/steps.py:make_sharded_eval_step``: the val loader packs
    ``n_data`` distinct volumes a step, each data rank evaluates its own
    (``images``, ``labels`` and ``weights`` are this rank's slices), the
    metrics and the loss are per volume (their sums all-reduced over the
    spatial group), and the weights zero the repeat-padding of a ragged
    last batch; the sums are all-reduced over the data axis, so every rank
    returns the global batch's."""

    @torch.no_grad()
    def eval_step(state, images, labels, weights):
        model = state.model
        model.eval()
        logits = model(images)
        per = segmentation_metrics_per_sample(logits, labels)
        with reduction_axis(SPATIAL_AXIS):
            per["loss"] = torch.stack([loss_fn(lg[None], lb[None])
                                       for lg, lb in zip(logits, labels)])
        w = weights.float()
        keys = [*per, "n"]
        sums = torch.stack([*((per[k].float() * w).sum() for k in per), w.sum()])
        sums = reduce_sum(sums, DATA_AXIS)
        return dict(zip(keys, sums))

    return eval_step


def make_distill_step(kd_loss_fn, augment: bool = False, nan_guard: bool = False):
    """distill_step(state, teacher, images, labels, generator) -> metrics.

    The student takes the train step with ``kd_loss_fn(student_logits,
    teacher_logits, labels)``. The teacher is a separate ``UNet3D`` with
    its parameters frozen (``requires_grad_(False)``); it runs its eval
    forward (BatchNorm folded) under ``torch.no_grad()`` on the step's
    (augmented) images, before the student's forward."""

    def distill_step(state, teacher, images, labels, generator=None):
        if augment:
            images, labels = _augment_and_shard(generator, images, labels)
        with span("step.forward"), torch.no_grad():
            teacher.eval()
            teacher_logits = teacher(images)
        body = _supervised_body(lambda logits, labels: kd_loss_fn(logits, teacher_logits, labels),
                                nan_guard)
        return _eager(body, (state,), (images, labels), (generator,), ("loss",))

    return distill_step


def _split_generator(generator: torch.Generator | None, n: int) -> list:
    """``n`` generators seeded from ``generator``'s next draws (None: n Nones)."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(int(s)) for s in seeds]


def _domain_rows(n_local: int):
    """On a data mesh, (global rows, this rank's rows) of the
    discriminator's input [source; target], for its dropout masks."""
    n_global, rows = data_rows(n_local)
    if n_global == n_local:
        return None
    idx = torch.arange(rows.start, rows.stop)
    return 2 * n_global, torch.cat([idx, idx + n_global])


def make_dann_step(loss_fn, lambda_domain: float, nan_guard: bool = False):
    """dann_step(seg_state, disc_state, src_images, src_labels, tgt_images,
    generator) -> metrics (dice, iou, acc of the source batch, task_loss,
    domain_loss, loss, and nonfinite with the guard).

    The JAX package's semantics, its double lambda included: the gradient
    reversal scales by -lambda and the total is task + lambda * domain, so
    the discriminator trains on lambda * CE and the features see
    -lambda**2 * dCE. One backward feeds both states, each with its own
    AdamW. The domain labels are 0 for the source and 1 for the target.
    ``generator`` seeds three dropout streams, in this order: the source
    forward's, the target forward's and the discriminator's.

    Both forwards are whole train-mode forwards, so the BatchNorm running
    statistics take the source batch and then the target batch, the
    decoder's included, as the JAX package's ``mut_t`` does. The target's
    logits are dropped at once: no decoder backward runs for them, and
    their activations are freed (a replayed step keeps the logits among its
    graph's outputs, for the model's forward hooks). The NaN guard covers
    both states' gradients and undoes both forwards' statistics. On one
    CUDA device the step's device work replays as a CUDA graph
    (:class:`_Replay`); the masks are drawn ahead from the three streams."""

    step = _Replay(_dann_body(loss_fn, lambda_domain, nan_guard),
                   ("task_loss", "domain_loss", "loss"))

    def dann_step(seg_state, disc_state, src_images, src_labels, tgt_images, generator=None):
        return step((seg_state, disc_state), (src_images, src_labels, tgt_images),
                    _split_generator(generator, 3))

    return dann_step


def _dann_body(loss_fn, lambda_domain: float, nan_guard: bool):
    """The DANN step's device work, ``body((model, disc), (src_images,
    src_labels, tgt_images), (g_src, g_tgt, g_disc)) -> (metrics, flag,
    saved)``: both forwards, the discriminator, the losses, the backward,
    the metrics and the guard's flag."""

    def body(models, inputs, sources):
        (model, disc), (src_images, src_labels, tgt_images), (g_src, g_tgt, g_disc) = (
            models, inputs, sources)
        with span("step.forward"):
            model.train()
            disc.train()
            saved = [b.clone() for b in _bn_buffers(model)] if nan_guard else None
            _zero_grads(model, disc)
            src_logits, src_feat = model(src_images, return_features=True, generator=g_src)
            task_loss = loss_fn(src_logits, src_labels)
            tgt_feat = model(tgt_images, return_features=True, generator=g_tgt)[1]
            feats = torch.cat([grad_reverse(src_feat, lambda_domain),
                               grad_reverse(tgt_feat, lambda_domain)])
            domain_logits = disc(feats, generator=g_disc, rows=_domain_rows(src_feat.shape[0]))
            domain_labels = torch.cat([
                torch.zeros(src_feat.shape[0], dtype=torch.long, device=feats.device),
                torch.ones(tgt_feat.shape[0], dtype=torch.long, device=feats.device),
            ])
            # the features' rows are replicated over the spatial axis
            with reduction_axis(DATA_AXIS):
                domain_loss = cross_entropy_loss(domain_logits, domain_labels)
            total = task_loss + lambda_domain * domain_loss
        _backward(total, model, disc)  # the discriminator's matmuls are full fp32 already
        with span("step.update"):
            metrics = segmentation_metrics(src_logits.detach(), src_labels)
            metrics.update(task_loss=task_loss.detach(), domain_loss=domain_loss.detach(),
                           loss=total.detach())
            flag = _finite_flag((model, disc)) if nan_guard else None
        return metrics, flag, saved

    return body
