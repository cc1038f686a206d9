"""Training: SAM prompt-encoder and mask-decoder fine-tuning on frozen image
embeddings, single process, data- and tensor-parallel (port of
``mars_tpu/parallel/train.py``).

SAM's published loss recipe: focal + dice on the single-mask logits, MSE
of the IoU head towards the IoU of the predicted mask.  The optimiser is
``optax.adamw(lr)`` written out on a tree of tensors (``AdamW``): Adam's
moments, then weight decay 1e-4 on every leaf, then -lr.

  - data parallelism (``mesh.n_data > 1``): each data rank steps on its
    own shard of the batch (``parallel.runner.shard_batch``), all shards
    of one size; its loss is its shard's mean, and gradients and metrics
    are averaged over the data group before the update, which then equals
    the full batch's on every rank.
  - tensor parallelism (``mesh.n_model > 1``): the decoder's attentions
    and MLPs sliced by ``parallel.mesh.shard_params`` run the rank's whole
    heads and columns (``models.sam._attn``); sliced leaves keep their
    slices of the gradient and of Adam's state, replicated leaves get the
    full gradient through the copy's backward all-reduce.

The image embeddings come from the frozen encoder under
``torch.no_grad()``: its kernels have no backward, and the JAX package
takes the embedding as an input too.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mars_tpu_torch.models import sam

AUX_KEYS = ("focal", "dice", "iou")


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    focal_weight: float = 20.0
    dice_weight: float = 1.0
    iou_weight: float = 1.0


def _focal_loss(logits, targets, alpha, gamma):
    p = torch.sigmoid(logits)
    # optax.sigmoid_binary_cross_entropy
    ce = -targets * F.logsigmoid(logits) - (1 - targets) * F.logsigmoid(-logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return (a_t * (1 - p_t) ** gamma * ce).mean()


def _dice_loss(logits, targets, eps=1.0):
    p = torch.sigmoid(logits)
    num = 2 * (p * targets).sum(dim=(-1, -2)) + eps
    den = p.sum(dim=(-1, -2)) + targets.sum(dim=(-1, -2)) + eps
    return (1 - num / den).mean()


def segmentation_loss(trainable, embedding, point_coords, point_labels, gt_masks,
                      cfg: sam.SamConfig, tcfg: TrainConfig):
    """trainable {"prompt_encoder", "decoder"}; embedding (B, G, G, C)
    frozen image embeddings; point_coords (B, K, 2); point_labels (B, K);
    gt_masks (B, 4G, 4G) {0, 1} at the low-res mask scale → (loss,
    {"focal", "dice", "iou"}).  One batched decode, a prompt set an
    embedding (JAX vmaps the decode over the examples)."""
    pe, dec = trainable["prompt_encoder"], trainable["decoder"]
    b, g = embedding.shape[0], embedding.shape[1]
    image_pe = sam.dense_pe(pe, (g, g))
    sparse = sam.embed_points(pe, point_coords, point_labels, (cfg.img_size, cfg.img_size),
                              pad=True)
    dense = sam.no_mask_dense(pe, (g, g))[None].expand(b, g, g, embedding.shape[-1])
    masks, iou_pred = sam.decode_masks(dec, embedding, image_pe, sparse, dense, cfg)
    logits = masks[:, 0]  # the single-mask slot
    focal = _focal_loss(logits, gt_masks, tcfg.focal_alpha, tcfg.focal_gamma)
    dice = _dice_loss(logits, gt_masks)
    # the IoU head regresses towards the predicted mask's actual IoU
    pred_bin = (logits > 0).to(logits.dtype)
    inter = (pred_bin * gt_masks).sum(dim=(-1, -2))
    union = torch.maximum(pred_bin, gt_masks).sum(dim=(-1, -2))
    actual_iou = inter / union.clamp(min=1.0)
    iou_loss = ((iou_pred[:, 0] - actual_iou.detach()) ** 2).mean()
    loss = tcfg.focal_weight * focal + tcfg.dice_weight * dice + tcfg.iou_weight * iou_loss
    return loss, {"focal": focal, "dice": dice, "iou": iou_loss}


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class AdamW:
    """``optax.adamw(learning_rate)`` at optax's defaults:
    ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0)``,
    ``add_decayed_weights(1e-4)`` on every leaf, then ``-learning_rate``.
    State {"count" (int32), "mu", "nu"}; ``update`` returns the updates, as
    optax's does."""

    B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params):
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        b1, b2 = self.B1, self.B2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        # 1 - decay ** count in float32, as optax computes the correction
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** count

        def leaf_update(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + self.EPS)
            return (u + self.WEIGHT_DECAY * p) * -self.learning_rate

        updates = tree_map(leaf_update, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu}


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(torch.add, params, updates)


def _data_mean(tensors, mesh) -> list:
    """Each tensor summed over the data group in one all-reduce, over n."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat = flat / mesh.n_data
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _check_shards(b: int, mesh) -> None:
    sizes = [torch.zeros((), dtype=torch.int64, device=mesh.device) for _ in range(mesh.n_data)]
    dist.all_gather(sizes, torch.tensor(b, dtype=torch.int64, device=mesh.device),
                    group=mesh.data_group)
    sizes = [int(s) for s in sizes]
    if len(set(sizes)) != 1:
        raise ValueError(f"data shards of unequal sizes {sizes}: the averaged gradient "
                         "would not be the full batch's")


def make_train_step(cfg: sam.SamConfig, tcfg: TrainConfig = TrainConfig(),
                    accum_steps: int = 1, remat: bool = False, mesh=None):
    """→ (optimizer, step(trainable, opt_state, embedding, coords, labels,
    gt_masks) → (trainable, opt_state, metrics {"loss", "focal", "dice",
    "iou"})).  ``trainable`` and the batch are the rank's: its
    ``shard_params`` slices under a model axis, its data shard under a data
    axis (``mesh``, a ``parallel.mesh.Mesh``; None: one process).

    ``accum_steps > 1``: gradient accumulation; the batch's leading axis is
    split into ``accum_steps`` equal microbatches run one after another,
    their gradients, losses and aux terms summed, then scaled by
    1/accum_steps; every loss term is a mean over an equal-size
    microbatch, so this is the full batch's gradient.  ``remat``: the loss
    forward under ``torch.utils.checkpoint`` (non-reentrant): activations
    are recomputed in the backward pass instead of held, the upscale stack
    (B, 4G, 4G, C/8) first among them."""
    opt = AdamW(tcfg.learning_rate)
    data_parallel = mesh is not None and mesh.n_data > 1

    def loss_fn(trainable, embedding, coords, labels, gt_masks):
        # entered inside the checkpointed function, so that its recompute
        # in the backward pass (on autograd's thread) reduces in the group too
        with mesh.tensor_parallel() if mesh is not None else contextlib.nullcontext():
            return segmentation_loss(trainable, embedding, coords, labels, gt_masks, cfg, tcfg)

    def grad_fn(trainable, embedding, coords, labels, gt_masks):
        leaves = tree_leaves(trainable)
        with torch.enable_grad():
            if remat:
                loss, aux = checkpoint(loss_fn, trainable, embedding, coords, labels, gt_masks,
                                       use_reentrant=False)
            else:
                loss, aux = loss_fn(trainable, embedding, coords, labels, gt_masks)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def step(trainable, opt_state, embedding, coords, labels, gt_masks):
        b = embedding.shape[0]
        if data_parallel:
            _check_shards(b, mesh)
        params = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
        if accum_steps == 1:
            loss, aux, grads = grad_fn(params, embedding, coords, labels, gt_masks)
        else:
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
            mb = b // accum_steps
            grads, loss, aux = None, 0.0, {k: 0.0 for k in AUX_KEYS}
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                loss_i, aux_i, grads_i = grad_fn(params, embedding[rows], coords[rows],
                                                 labels[rows], gt_masks[rows])
                grads = grads_i if grads is None else [a + g for a, g in zip(grads, grads_i)]
                loss = loss + loss_i
                aux = {k: aux[k] + aux_i[k] for k in AUX_KEYS}
            inv = 1.0 / accum_steps
            grads = [g * inv for g in grads]
            loss = loss * inv
            aux = {k: v * inv for k, v in aux.items()}
        metrics = [loss] + [aux[k] for k in AUX_KEYS]
        if data_parallel:
            grads = _data_mean(grads, mesh)
            metrics = _data_mean([m.reshape(1) for m in metrics], mesh)
            metrics = [m.reshape(()) for m in metrics]
        grads = _unflatten(trainable, grads)
        trainable = tree_map(torch.Tensor.detach, trainable)
        updates, opt_state = opt.update(grads, opt_state, trainable)
        trainable = apply_updates(trainable, updates)
        return trainable, opt_state, dict(zip(("loss",) + AUX_KEYS, metrics))

    return opt, step
