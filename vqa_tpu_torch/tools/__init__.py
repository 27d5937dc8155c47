"""The port's timing probes: the Pallas probes of ``tools/exp_*.py`` on the card.

Each module mirrors one JAX probe by file name and computes its function
with the port's hand-written kernels (A-F), which take the place of the
TPU probe's Pallas kernel; the probe's TPU-only variants (planar or
H-pair-packed stores, grid knobs) collapse into that one kernel, as each
module's docstring says. Run one as ``python -m vqa_tpu_torch.tools.<name>``
(on the card unless ``--device cpu``; the TPU probes' ``BENCH_BATCH``,
``BENCH_STEPS`` and ``EXP_*`` settings apply). ``chip_smoke.py`` drives
them all (:data:`PROBES`).
"""

# module name -> the rows of PERF.md's table of TPU kernels it ports
PROBES = {
    "exp_conv0": "6a", "exp_fuse01": "6b, 6c", "exp_hpack_tap": "6d", "exp_nhwc_tap": "6e",
    "exp_ptap": "6f", "exp_r4_bblk": "6g", "exp_r5_conv0": "6h", "exp_r5_kdepth": "6i",
    "exp_r5_mosaic_dot": "6j", "exp_tapconv": "6k",
}
