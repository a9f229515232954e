"""kubeadmiral_tpu_torch — the batched replica scheduler in PyTorch + CUDA.

A port of the ``kubeadmiral_tpu`` scheduling engine to PyTorch, with the
per-cell phase-1 front (filters, reason bits, score plugins with per-row
normalisation) as a hand-written CUDA kernel for Hopper (``sm_90a``).
The JAX package stays the reference: every ported function is held
bit-identical to its JAX counterpart on the same inputs.

This package imports ``torch`` and never ``jax``, and nothing of
``kubeadmiral_tpu``: the framework-free modules it needs (the data
model, quantity parsing, label matching, FNV hashing, the numpy
featurizers and the control plane's controllers) are its own copies,
and it reads no environment variable.

Layout (mirrors ``kubeadmiral_tpu``):
  models/      data model (SchedulingUnit, ClusterState), FederatedTypeConfig,
               propagation policies, scheduling profiles
  utils/       quantity parsing, label selectors, FNV hashing, dotted paths,
               JSON merge patches
  ops/         torch tensor math: filters, scores, select, weights,
               planner, the fused tick, and phase1 (kernel + plain twin)
  csrc/        CUDA C++ sources of the hand-written kernels
  scheduler/   numpy featurizers, the chunked SchedulerEngine, the webhook
               plugin client
  runtime/     metrics, flight recorder, snapshots; the reconcile runtime
               (queue, workers, pending-controllers, host batch, event sink,
               lock check, trace, SLO recorder, tenancy, informers, the
               pod informer)
  federation/  the cluster, federate, scheduler, sync, override, follower,
               nsautoprop, policyrc, status, auto-migration and monitor
               controllers, their shared helpers and the shard map
  transport/   the per-member circuit breaker
  testing/     seeded benchmark worlds, the in-memory apiserver fleet
               (fakekube.py), the control plane's world (cpworld.py)
  convert.py   numpy planes <-> the port's tensors on a device

The engine runs on the card unless the caller asks for the CPU
(``SchedulerEngine(device="cpu")``); without CUDA the default raises.
"""
