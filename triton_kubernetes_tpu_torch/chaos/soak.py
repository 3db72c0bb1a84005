"""One round of the chaos soak: apply -> train -> preempt -> repair ->
resume, the port of the reference's soak loop (its ``tests/test_chaos.py``
``test_soak_apply_train_preempt_repair_resume``), at the same points:

1. ``generate_spec(seed, "soak")`` passes :func:`~.runner.run_scenario`
   (its GPU twin through the infra arms: host code);
2. the twin's document is applied to a live executor on the simulated
   cloud;
3. a trainer takes two steps and saves a checkpoint
   (:class:`~..train.checkpoint.CheckpointManager`);
4. the first GPU pool is preempted and repaired with
   :func:`~..workflows.repair.repair_slice_auto`, and the cloud's
   preempted set comes back empty;
5. the state is restored and two more steps run.

The caller holds the four losses to an uninterrupted four-step run
(:func:`train_losses`); on the card they must be ``torch.equal``.
A stage that does not do what the loop needs raises ``RuntimeError``.
The trainer is the caller's (``step`` and ``fresh_state``), so a test can
carry parameters over from another package and ``chip_smoke.py`` can pick
the model whose attention runs the flash kernels.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def train_losses(step: Callable, state: Any, batch: Dict[str, Any],
                 n: int) -> Tuple[Any, List[torch.Tensor]]:
    """``n`` steps of ``step`` on one batch: the state and each step's loss
    (a detached copy of the device scalar)."""
    losses = []
    for _ in range(n):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].detach().clone())
    return state, losses


def soak_round(seed: int, step: Callable, fresh_state: Callable[[], Any],
               batch: Dict[str, Any], ckpt_dir: str, ns: str = "soak",
               device: str = "cuda",
               log: Optional[Callable[[str], None]] = None
               ) -> Dict[str, Any]:
    """One round of the soak loop (module docstring) for scenario ``seed``
    of the ``soak`` profile. ``fresh_state()`` builds the trainer's step-0
    state (the run and the restore's template); checkpoints land under
    ``ckpt_dir``. Returns the scenario's ``result``, the GPU ``pool``
    preempted (a ``gpu_pools`` row), the module key it was ``repaired``
    as, the ``restored_step`` and the four ``losses`` (two before the
    checkpoint, two after the restore). Raises ``RuntimeError`` at the
    first stage that fails; the live document is destroyed and its state
    dropped either way."""
    from ..backends import MemoryBackend
    from ..executor.dagspec import document_from_spec, gpu_pools
    from ..executor.engine import (_MEMORY_STATES, LocalExecutor,
                                   load_executor_state, save_executor_state)
    from ..train.checkpoint import CheckpointManager
    from ..utils.logging import Logger
    from ..workflows import repair_slice_auto
    from .generator import generate_spec, twin_spec
    from .runner import run_scenario

    say = log or (lambda m: None)
    spec = generate_spec(seed, "soak")
    result = run_scenario(spec, ns=ns, device=device)
    if not result.passed:
        raise RuntimeError(f"soak seed {seed}: {result.violations}")
    say(f"soak seed {seed}: checked {result.checked}, simulated "
        f"{result.stats['simulated_seconds']} s")

    twin = twin_spec(spec)
    name = f"{ns}-train"
    doc = document_from_spec(twin["topology"], name)
    ex = LocalExecutor(log=lambda m: None,
                       logger=Logger(stream=io.StringIO()))
    try:
        ex.apply(doc)
        pools = gpu_pools(twin["topology"])
        if not pools:
            raise RuntimeError(f"soak seed {seed} declares no GPU pool")
        pool = pools[0]

        mgr = CheckpointManager(ckpt_dir)
        state, losses = train_losses(step, fresh_state(), batch, 2)
        mgr.save(2, state, wait=True)
        mgr.close()
        del state

        view = ex.cloud_view(doc)
        view.preempt_slice(pool["slice_id"])
        est = load_executor_state(doc)
        est.cloud = view.to_dict()
        save_executor_state(doc, est)
        backend = MemoryBackend()
        backend.persist(doc)
        repaired = repair_slice_auto(backend, ex, name, pool["cluster"],
                                     slice_id=pool["slice_id"])
        left = ex.cloud_view(doc).preempted_slices()
        if left:
            raise RuntimeError(f"still preempted after the repair: "
                               f"{sorted(left)}")
        say(f"soak seed {seed}: {pool['slice_id']} ({pool['accelerator']}) "
            f"preempted and repaired as {repaired}")

        mgr = CheckpointManager(ckpt_dir)
        latest = mgr.latest_step()
        if latest != 2:
            raise RuntimeError(f"latest checkpoint step {latest}, want 2")
        state = mgr.restore(fresh_state())
        restored_step = mgr.last_restored_step
        mgr.close()
        state, after = train_losses(step, state, batch, 2)
        del state
    finally:
        ex.destroy(doc)
        _MEMORY_STATES.pop(name, None)
    return dict(result=result, pool=pool, repaired=repaired,
                restored_step=restored_step, losses=losses + after)
