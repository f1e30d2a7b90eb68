"""HATRPO: Heterogeneous-Agent Trust Region Policy Optimization.

Port of `onpolicy_tpu/algorithms/hatrpo.py` (the reference's
`hatrpo_trainer.py`), a subclass of the port's HAPPO. One pass over
`num_mini_batch` minibatches (no ppo_epoch, `train` :355-375); per
minibatch:

  * critic: one Adam step on the clipped value loss (:219-231);
  * actor: a natural-gradient TRPO step —
      g     = ∇θ E[Π exp(Δlogp)·factor·adv], active-mask mean  (:233-242)
      Fv    = ∇²(KL)·v + 0.1·v                                (:175-184)
      dir   = conjugate_gradient(F, g), 10 fixed iterations   (:157-173)
      step  = dir / sqrt(dir·F·dir / (2·kl_threshold))        (:265-267)
      then `ls_step` backtracking halvings; the first candidate with
      KL(old‖new) < kl_threshold, improvement ratio > accept_ratio and a
      positive improvement wins; if none does the old parameters are kept
      (:277-321).

The KL is the reference's: for a Box head the closed-form gaussian
KL(old ‖ new), log σ − log σ_old + (σ_old² + (μ_old − μ)²)/(2σ²) − ½,
summed keepdim; for categoricals the smoothed logit-space surrogate
exp(Δ) − 1 − Δ (`kl_approx`, :130-153); the old side is given detached.
The critic's normalizer updates under `use_popart` or `use_valuenorm`
(the stats-only normalizer, as HAPPO's).
The JAX package takes the Fisher-vector product forward-over-reverse
(`jax.jvp` of the KL gradient); here it is reverse-over-reverse, the
reference trainer's own form: the KL gradient is taken once with
`create_graph=True`, and each product is the gradient of `grad_kl · v`.
The actor's parameters are flattened into one vector (`_flatten`) for the
CG and the line search, and unflattened for each evaluation. The
sequence GRU of this actor runs as the plain scan (`models/gru.py`): the
product differentiates it twice.

Over a data mesh (`mesh`) each rank holds a share of the minibatch's
rows, and every batch quantity is summed over the ranks: the critic's
gradient with its loss, the surrogate's gradient g with the surrogate,
each Fisher-vector product (one all-reduce a CG step; the KL's double
backward stays local), and each line-search trial's surrogate and KL.
So CG, the step and the acceptance are the same on every rank. On a
`(data, model)` mesh (`shards`, as in `algorithms/mappo.py`) each update
gathers the full actor and critic once; CG and the line search run on
the full flat vectors on every rank, and only this rank's block of the
accepted parameters is kept. The critic's step is Adam on the blocks,
the clip from the full gradient. `fisher_vector_product`,
`natural_step` and `_old_outputs` take a state with the full actor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms.happo import HAPPO
from onpolicy_torch.ops import losses
from onpolicy_torch.ops import valuenorm as vn
from onpolicy_torch.parallel import distributed
from onpolicy_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

CG_ITERS = 10
DAMPING = 0.1


def _flatten(tree):
    """→ (one flat vector of the tree's leaves, unflatten(vector) → tree).
    The order is `tree_leaves`'; compare with JAX's `ravel_pytree` leaf by
    leaf, not as flat vectors."""
    leaves = tree_leaves(tree)
    sizes = [x.numel() for x in leaves]

    def unflatten(theta):
        parts = torch.split(theta, sizes)
        return tree_unflatten(tree, [p.view_as(x)
                                     for p, x in zip(parts, leaves)])
    return torch.cat([x.reshape(-1) for x in leaves]), unflatten


class NaturalStep(NamedTuple):
    """What the actor's step is made of, before the line search."""
    theta0: torch.Tensor       # the actor's parameters, flat
    unflatten: object          # flat vector → parameter tree
    loss0: torch.Tensor        # surrogate at theta0
    g: torch.Tensor            # its gradient
    step_dir: torch.Tensor     # CG's solution of F·x = g
    step_size: torch.Tensor
    full_step: torch.Tensor    # step_size · step_dir


class HATRPO(HAPPO):
    """Trainer: the MAPPO/HAPPO interface, the TRPO actor update."""

    def _policy_outputs(self, actor_params, mb):
        """(log_probs, entropy, mu, std, logits), flat rows."""
        active = mb["active_masks"] if self.cfg.use_policy_active_masks \
            else None
        args = (actor_params, mb["obs"], mb["rnn_states"], mb["actions"],
                mb["masks"], mb.get("available_actions"), active)
        if self.cfg.is_recurrent:
            return self.actor.evaluate_trpo_seq(*args)
        return self.actor.evaluate_trpo(*args)

    @staticmethod
    def _kl(new_out, old_out):
        """KL(old ‖ new) per row, summed keepdim, against the old outputs
        (given detached): closed-form gaussian when the head has a mean,
        else the smoothed categorical form over the logits."""
        _, _, mu, std, logits = new_out
        _, _, mu_old, std_old, logits_old = old_out
        if mu is None:
            delta = logits - logits_old
            kl = torch.exp(delta) - 1.0 - delta
        else:
            kl = (torch.log(std) - torch.log(std_old)
                  + (std_old.square() + (mu_old - mu).square())
                  / (2.0 * std.square()) - 0.5)
        return kl.sum(-1, keepdim=True)

    def _rows(self, mb):
        """The minibatch's flat per-row terms of the surrogate."""
        am = mb["active_masks"].reshape(-1, 1)
        factor = mb.get("factor")
        factor = factor.reshape(-1, 1) if factor is not None \
            else torch.ones_like(am)
        old_logp = mb["old_action_log_probs"].reshape(
            -1, mb["old_action_log_probs"].shape[-1])
        return am, factor, old_logp, mb["advantages"].reshape(-1, 1)

    def _surrogate(self, out, mb):
        am, factor, old_logp, adv = self._rows(mb)
        ratio = torch.exp((out[0] - old_logp).sum(-1, keepdim=True))
        surr = ratio * factor * adv
        return losses.masked_mean(
            surr, am if self.cfg.use_policy_active_masks else None)

    def _total(self, parts):
        """Each rank's parts summed over the ranks (one all-reduce)."""
        return distributed.all_reduce_sum(parts, self.mesh)

    def _critic_step(self, state, mb, critic_params):
        """One Adam step of the critic on the whole minibatch `mb` (its
        returns fold into the normalizer; this rank's share makes the
        loss), computed with the full `critic_params` → (the state's
        critic parameters stepped, opt state, vnorm, value loss, gradient
        norm)."""
        cfg = self.cfg
        vnorm = state.vnorm
        if cfg.use_popart or cfg.use_valuenorm:
            vnorm = vn.update(vnorm, mb["returns"].reshape(-1, 1))
        mb = self._share(mb)
        cp = tree_map(lambda x: x.detach().requires_grad_(True),
                      critic_params)
        leaves = tree_leaves(cp)
        with torch.enable_grad():
            args = (cp, mb["share_obs"], mb["rnn_states_critic"], mb["masks"])
            if cfg.is_recurrent:
                values = self.critic.forward_seq(*args)
            else:
                values, _ = self.critic.forward(*args)
            v_loss = losses.value_loss(
                values, mb["value_preds"], mb["returns"], mb["active_masks"],
                vnorm, clip_param=cfg.clip_param,
                use_clipped_value_loss=cfg.use_clipped_value_loss,
                use_huber_loss=cfg.use_huber_loss,
                huber_delta=cfg.huber_delta,
                use_value_active_masks=cfg.use_value_active_masks
            ) * cfg.value_loss_coef
            grads = torch.autograd.grad(v_loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        grads, aux = distributed.sum_over_ranks(
            grads, {"value_loss": v_loss}, self.mesh)
        params, opt = self.critic_tx.update(
            tree_unflatten(cp, grads), state.critic_opt_state,
            state.critic_params, self.shards.cut_grads("critic_params"))
        return params, opt, vnorm, aux["value_loss"], \
            losses.global_grad_norm(grads)

    def fisher_vector_product(self, state, mb, old_out=None):
        """→ fvp(v) = ∇²KL(θ0)·v + DAMPING·v over the flat actor
        parameters, reverse-over-reverse: the KL gradient is built once
        with its graph, and each product is the gradient of grad_kl · v."""
        if old_out is None:
            old_out = self._old_outputs(state, mb)
        theta0, unflatten = _flatten(state.actor_params)
        theta = theta0.detach().requires_grad_(True)
        with torch.enable_grad():
            new_out = self._policy_outputs(unflatten(theta), mb)
            kl = losses.batch_mean(self._kl(new_out, old_out))
            grad_kl, = torch.autograd.grad(kl, theta, create_graph=True)

        def fvp(v):
            with torch.enable_grad():
                hv, = torch.autograd.grad(grad_kl @ v, theta,
                                          retain_graph=True)
            hv, = self._total([hv])
            return hv + DAMPING * v
        return fvp

    def _old_outputs(self, state, mb):
        with torch.no_grad():
            return self._policy_outputs(state.actor_params, mb)

    def natural_step(self, state, mb, old_out=None) -> NaturalStep:
        """The surrogate's gradient g, the CG direction F⁻¹g in CG_ITERS
        fixed iterations (openai-baselines form, with the 1e-12 guards),
        and the step that puts the quadratic KL at `kl_threshold`."""
        if old_out is None:
            old_out = self._old_outputs(state, mb)
        theta0, unflatten = _flatten(state.actor_params)
        theta = theta0.detach().requires_grad_(True)
        with torch.enable_grad():
            loss0 = self._surrogate(
                self._policy_outputs(unflatten(theta), mb), mb)
            g, = torch.autograd.grad(loss0, theta)
        g, loss0 = self._total([g, loss0.detach()])
        fvp = self.fisher_vector_product(state, mb, old_out)

        x = torch.zeros_like(g)
        r, p = g.clone(), g.clone()
        rdotr = g @ g
        for _ in range(CG_ITERS):
            Ap = fvp(p)
            alpha = rdotr / torch.clamp_min(p @ Ap, 1e-12)
            x = x + alpha * p
            r = r - alpha * Ap
            new_rdotr = r @ r
            beta = new_rdotr / torch.clamp_min(rdotr, 1e-12)
            p = r + beta * p
            rdotr = new_rdotr
        shs = 0.5 * (x @ fvp(x))
        step_size = 1.0 / torch.sqrt(
            torch.clamp_min(shs / self.cfg.kl_threshold, 1e-12))
        return NaturalStep(theta0.detach(), unflatten, loss0.detach(), g, x,
                           step_size, step_size * x)

    def line_search(self, step: NaturalStep, mb, old_out):
        """Backtracking over fractions 0.5**i, i < ls_step; the first
        candidate with KL < kl_threshold, improvement / expected
        improvement > accept_ratio and improvement > 0 wins. → (theta,
        fraction (0.0 when every candidate was rejected and theta is the
        old one), kl, improvement, expected improvement; the last three 0
        when rejected)."""
        cfg = self.cfg
        expected0 = step.g @ step.full_step
        zero = torch.zeros((), device=step.theta0.device)
        for i in range(cfg.ls_step):
            fraction = 0.5 ** i
            cand = step.theta0 + fraction * step.full_step
            out = self._policy_outputs(step.unflatten(cand), mb)
            surr, kl = self._total([
                self._surrogate(out, mb),
                losses.batch_mean(self._kl(out, old_out))])
            improve = surr - step.loss0
            expected = expected0 * fraction
            ok = ((kl < cfg.kl_threshold)
                  & (improve / torch.clamp_min(expected, 1e-12)
                     > cfg.accept_ratio)
                  & (improve > 0))
            if bool(ok):
                return cand, fraction, kl, improve, expected
        return step.theta0, 0.0, zero, zero, zero

    def _trpo_update(self, state, mb):
        with distributed.global_batch(self.mesh):
            return self._trpo_update_in(state, mb)

    def _trpo_update_in(self, state, mb):
        full = self.shards.gathered(state)
        critic_params, c_opt, vnorm, v_loss, c_norm = self._critic_step(
            state, mb, full.critic_params)
        mb = self._share(mb)
        old_out = self._old_outputs(full, mb)
        step = self.natural_step(full, mb, old_out)
        theta, fraction, kl, improve, expected = self.line_search(
            step, mb, old_out)
        actor_params = step.unflatten(theta)
        new_out = self._policy_outputs(actor_params, mb)
        old_logp = self._rows(mb)[2]
        entropy, ratio = self._total([
            new_out[1].detach(), losses.batch_mean(torch.exp(
                (new_out[0] - old_logp).sum(-1, keepdim=True)))])
        metrics = {
            "value_loss": v_loss, "critic_grad_norm": c_norm,
            "kl": kl, "loss_improve": improve, "expected_improve": expected,
            "dist_entropy": entropy, "ratio": ratio,
            "accepted": torch.tensor(float(fraction > 0),
                                     device=theta.device)}
        actor_params = self.shards.cut_tree("actor_params", tree_map(
            lambda x: x.detach().clone(), actor_params))
        return state.replace(actor_params=actor_params,
                             critic_params=critic_params,
                             critic_opt_state=c_opt, vnorm=vnorm), metrics

    @torch.no_grad()
    def train(self, state, buf: buf_lib.RolloutBuffer,
              generator: Optional[torch.Generator] = None,
              factor: Optional[torch.Tensor] = None,
              perms=None):
        """One pass: a TRPO update on each of the `num_mini_batch`
        minibatches (no ppo_epoch). With several minibatches the
        permutation is drawn from `generator`, or taken from `perms[0]`.
        Metrics are 0-dim tensors, means over the updates."""
        cfg = self.cfg
        adv = losses.normalize_advantages(
            buf.advantages,
            buf.active_masks[:-1] if cfg.use_policy_active_masks else None)
        mbs = self._sample_minibatches(
            buf, adv, generator, None if perms is None else perms[0], factor)
        history = []
        for mb in mbs:
            state, m = self._trpo_update(state, mb)
            history.append(m)
        return state, {k: torch.stack([h[k] for h in history]).mean()
                       for k in history[0]}
