"""The reference's tools (:file:`tools/` beside :mod:`dust_tpu`), ported:
one module per tool under the same name, each run as ``python -m
dust_tpu_torch.tools.<name>``, on the card unless ``--device cpu`` is
given.

* :mod:`~dust_tpu_torch.tools.rmse` — RMSE / PSNR between two renders;
* :mod:`~dust_tpu_torch.tools.quality_setup` — the ground truth's scene
  settings and camera;
* :mod:`~dust_tpu_torch.tools.gen_ground_truth` — the converged ground
  truth of ``tests/golden/``;
* :mod:`~dust_tpu_torch.tools.gen_bluenoise` — the blue-noise assets;
* :mod:`~dust_tpu_torch.tools.bench_trace` — each trace pass alone on a
  frame's real rays;
* :mod:`~dust_tpu_torch.tools.profile_stages` — each stage of the frame
  alone;
* :mod:`~dust_tpu_torch.tools.profile_frame` — the frame under
  ``torch.profiler``;
* :mod:`~dust_tpu_torch.tools.bench_matrix` — every bench config, one
  JSON line each.
"""
