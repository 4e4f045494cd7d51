"""Attribution tools of the PyTorch/CUDA port: where a frame's time goes on
the card.

Each module is the port's counterpart of one attribution tool of the JAX
package (``tools/`` at the repository root), measuring the same thing on the
card through the port's own entry points::

    python -m cellularautomatons3d_tpu_torch.tools.<name> [options]

* :mod:`.profile_trace` (``tools/profile_trace.py``): a ``torch.profiler``
  trace of K frames of one frame path, written as ``trace.json``, and its
  summary;
* :mod:`.trace_summary` (``tools/xplane_summary.py``): the summary of any
  Chrome-format trace the port exports, with no GPU: device time and launches
  by kernel, the device's busy and idle share, the longest idle gaps with the
  host operation open at each;
* :mod:`.profile_gi` (``tools/profile_gi.py`` and ``tools/profile_gi2.py``):
  the one-bounce GI frame cut into its parts;
* :mod:`.profile_frame` (``tools/profile_frame.py``): K1's variants;
* :mod:`.bench_dense` (``tools/bench_dense.py``): composed frames on a dense
  scene, without the CA step;
* :mod:`.bench_scale` (``tools/bench_scale.py``): the 512³ / 1024³ and
  lighting scale lines;
* :mod:`.bench_512_ablate` (``tools/bench_512_ablate.py``): the 512³ sliced
  frame with and without its occlusion pass, and K4 and K2 with the coarse
  column skip on and off.

Every tool prints one JSON line per scenario with the card's name and power
limit (``nvidia-smi``), runs on ``cuda`` by default and raises without a
card; ``--device cpu --small`` runs it at a test size on the kernels' plain
twins, where its times are the host's and no device time is measured.
"""
