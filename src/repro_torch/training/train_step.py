"""The training step (counterpart of ``repro.training.train_step``;
Ulysses training, where SP comes from).

One step on every rank of the layout, as the reference's ``shard_map``
runs its body on every device: the local loss and its gradients
(``transformer.loss_body`` through the differentiable collectives, so a
rank's gradients are the reference's per-device ones), accumulated over
microbatches in the reference's order, cast to fp32 and summed over (dp,
sp) (or through the int8 compression), then AdamW with ZeRO-1 moment
slices over dp. The parameters live in the model and are updated in place;
the ``Trainer`` takes the port's ``Groups`` (through the model's shard)
where the reference takes a mesh."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.models import Model
from repro_torch.models import transformer as T
from .compress import int8_compress_psum, plain_psum
from .optimizer import AdamWConfig, adamw_init, adamw_update, stack_index


def reference_leaves(names, cfg):
    """The port's parameter names grouped by the reference's leaves, in
    order of first appearance: a layer of the reference's stacked body
    belongs to the one array of its pattern slot and leaf name (over every
    repeat); every other parameter is a leaf of its own."""
    groups = {}
    for name in names:
        r = stack_index(name, cfg)
        if r is None:
            key = name
        else:
            i = int(name.split(".")[1]) - len(cfg.prefix_layers)
            key = (i % len(cfg.layer_pattern), name.split(".", 2)[2])
        groups.setdefault(key, []).append(name)
    return list(groups.values())


@dataclass
class Trainer:
    model: Model
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    microbatch: int = 0              # 0 = no accumulation
    grad_compression: str = "none"   # "none" | "int8"
    remat: bool = True

    def __post_init__(self):
        if self.grad_compression not in ("none", "int8"):
            raise ValueError(f"grad_compression {self.grad_compression!r}: "
                             "use 'none' or 'int8'")
        T.check_trainable(self.model.cfg)

    @property
    def reduce_group(self):
        """The (dp, sp) group the gradients are summed over (None on one
        rank)."""
        sh = self.model.shard
        return sh.axes_group(("data", "sp") if sh.lay.sp > 1 else ("data",))

    # ------------------------------------------------------------------
    def init_opt_state(self) -> dict:
        """Zero moments (this rank's ZeRO-1 slices), step 0 and, with int8
        compression, a zero fp32 error-feedback buffer per parameter."""
        st = adamw_init(self.model, self.opt)
        if self.grad_compression == "int8":
            st["err"] = {name: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                         for name, p in self.model.params.named_parameters()}
        return st

    # ------------------------------------------------------------------
    def grads(self, tokens, labels):
        """This rank's loss and fp32 gradients (before the (dp, sp)
        reduction) for the global batch ``tokens``/``labels`` [B, S]: the
        local rows split into ``microbatch`` consecutive parts in order,
        each part's gradients added into fp32 sums as its backward
        produces them (a hook per parameter, so no second copy of the
        gradients is held), then divided by the count, as the loss is; or
        one pass without accumulation. Returns (loss, {name: gradient})."""
        model = self.model
        tk, lb = model.local_batch(tokens), model.local_batch(labels)
        micro = self.microbatch if self.microbatch and self.microbatch > 1 \
            else 1
        if tk.shape[0] % micro:
            raise ValueError(f"{tk.shape[0]} local rows do not split into "
                             f"{micro} microbatches")
        bs = tk.shape[0] // micro
        with model.trainable() as named:
            acc = {name: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                   for name, p in named.items()}

            def hook(name):
                def add(p):
                    acc[name].add_(p.grad)
                    p.grad = None
                return add
            handles = [p.register_post_accumulate_grad_hook(hook(name))
                       for name, p in named.items()]
            try:
                loss = torch.zeros((), dtype=torch.float32, device=tk.device)
                for i in range(micro):
                    part = slice(i * bs, (i + 1) * bs)
                    lv = T.loss_body(model.params, tk[part], lb[part],
                                     model.cfg, remat=self.remat)
                    lv.backward()
                    loss = loss + lv.detach()
            finally:
                for h in handles:
                    h.remove()
        if micro > 1:
            for a in acc.values():
                a.div_(micro)
            loss = loss / micro
        return loss, acc

    def step(self, opt_state: dict, tokens, labels):
        """One training step on this rank: the parameters of the model
        and the moments of ``opt_state`` are updated in place. Returns (the
        new optimizer state, the loss, a 0-d fp32 tensor equal on every
        rank)."""
        loss, grads = self.grads(tokens, labels)
        group = self.reduce_group
        if self.grad_compression == "int8":
            # one scale per reference leaf: its stacked layers share it.
            # Above world size 1 the reference runs on a mesh, whose (dp,
            # sp) axes are named even where they have one device, and it
            # quantizes there too
            new_err = {}
            named = self.model.lay.world > 1
            for names in reference_leaves(list(grads), self.model.cfg):
                outs, errs = int8_compress_psum(
                    [grads[n] for n in names],
                    [opt_state["err"][n] for n in names], group, named)
                grads.update(zip(names, outs))
                new_err.update(zip(names, errs))
        else:
            for name in grads:
                grads[name], _ = plain_psum(grads[name], None, group)
        state = adamw_update(self.model, grads, opt_state, self.opt)
        if self.grad_compression == "int8":
            state["err"] = new_err
        return state, loss
