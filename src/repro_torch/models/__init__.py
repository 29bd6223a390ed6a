"""The LM substrate's model code, the port's copy of ``repro.models``:

  config       — ArchConfig (every family's switches), ShapeConfig, SHAPES
  layers       — RMSNorm, RoPE, chunked GQA attention, decode attention,
                 SwiGLU MLP, capacity-based MoE
  ssm          — Mamba2 / SSD: chunked prefill and the recurrent decode step
  transformer  — the block plan, init, forward, prefill, decode_step
  model        — family dispatch, the serve entry points, build_params,
                 build_cache, demo_batch

Plain functions over nested dicts of tensors with the reference's keys and
shapes, computed with torch ops (the reference runs no Pallas kernel here).
"""
