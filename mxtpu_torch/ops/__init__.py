"""Ops of the port: RMSNorm and rotary embedding (``contrib``), Switch
expert routing (``moe``, plain PyTorch), the paged
KV-cache index ops (``tensor``), and the two paged-attention kernels
with their plain versions (``paged_attention``, ``prefill_attention``;
built by ``_build`` from ``mxtpu_torch/csrc`` at first use)."""
