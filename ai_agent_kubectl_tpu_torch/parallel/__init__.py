"""Parallel layers of the port: the MoE MLP on one card (``moe.py``).
The mesh paths (expert, tensor and pipeline parallelism) wait for the
multi-GPU slice (ROADMAP.md A8)."""
