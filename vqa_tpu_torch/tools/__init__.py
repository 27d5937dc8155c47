"""The port's tools: the timing probes and the run tools of ``tools/*.py``.

The timing probes (:data:`PROBES`) mirror the JAX package's Pallas probes
``tools/exp_*.py`` one module each, by file name, and compute their
functions with the port's hand-written kernels (A-F), which take the place
of the TPU probe's Pallas kernel; the probe's TPU-only variants (planar or
H-pair-packed stores, grid knobs) collapse into that one kernel, as each
module's docstring says. The run tools (:data:`TOOLS`) mirror the JAX
repo's other scripts: synthetic datasets, accuracy runs, the dress
rehearsal, serving latency, device memory, a VGG stage profile and a
trace of the headline step. Run one as ``python -m
vqa_tpu_torch.tools.<name>``: on the card unless ``--device cpu`` (the
dataset generator and ``export_vgg_pth`` run on the host); the JAX tools'
flags and ``BENCH_BATCH``, ``BENCH_STEPS``, ``BENCH_MODE``,
``PROFILE_STEPS``, ``PROFILE_OUT`` and ``EXP_*`` settings apply.
``chip_smoke.py`` drives them all.
"""

# module name -> the rows of PERF.md's table of TPU kernels it ports
PROBES = {
    "exp_conv0": "6a", "exp_fuse01": "6b, 6c", "exp_hpack_tap": "6d", "exp_nhwc_tap": "6e",
    "exp_ptap": "6f", "exp_r4_bblk": "6g", "exp_r5_conv0": "6h", "exp_r5_kdepth": "6i",
    "exp_r5_mosaic_dot": "6j", "exp_tapconv": "6k",
}

# module name -> (the JAX repo's tool it ports, whether it needs the card
# unless given --device cpu)
TOOLS = {
    "make_synth_dataset": ("tools/make_synth_dataset.py", False),
    "run_accuracy": ("tools/run_accuracy.py", True),
    "dress_rehearsal": ("tools/dress_rehearsal.py", True),
    "latency_report": ("tools/latency_report.py", True),
    "mem_report": ("tools/mem_report.py", True),
    "export_vgg_pth": ("tools/export_vgg_pth.py", False),
    "profile_vgg": ("tools/profile_vgg.py", True),
    "profile_headline": ("tools/profile_headline.py", True),
}
