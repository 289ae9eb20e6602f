#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 10] [--views 20] [--profile] [--kernels-only]

Phases, each reported on its own line:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build every hand-written kernel from ``unboundednerfpytorch_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together);
  3. time an empty kernel (the launch floor), then hold each kernel against
     its plain PyTorch version on the card and time kernel, plain version,
     bound and, where one PyTorch call computes the same function, that call.
     A time is a device time: CUDA events around a call, or, for a call under
     0.2 ms, around many launches in one CUDA graph, over the count; the time
     of a call through the Python wrapper is printed beside it. The TV
     injection runs at the train step's two shapes (bf16 and f32, gate 0 and
     1, sparse and dense, out of place and in place) and at four ragged shapes
     (also through views that are aligned otherwise, and with the kernel of
     one thread an element forced); the march forward at the train step's
     shape with residuals, at a render chunk's without a gradient (its entry
     sums the two) and at nine ragged shapes (S of 1, 17, 31, 33, 96, 130 and
     200, N no multiple of a block's rays, rays that end at their first sample,
     masked tails), the backward fed by each forward's residuals and held to
     the plain version. A sample whose transmittance lies within
     rounding of the early-exit threshold may fall on the other side than in
     the plain version: such samples are counted and bounded, not absorbed in
     the tolerance; the backward sums in another order than the plain version,
     which its tolerance allows for element by element
     (``march_backward_tolerance``). The same checks and times run at the
     shapes of phases 7 and 8: TV on DCVGO's one-bank bicycle grids (bf16), on
     DMPIGO's fern grids (f32, x and y weighed otherwise than z), on Truck.py's
     seven banks of ~319^3 (2.7 G elements, held bank by bank), on
     waymo_no_block.py's (seven banks of 299^3, k0 of 3 channels, bf16) and on
     grass.py's (seven banks of 319^3, f32, bank by bank); both march kernels
     at DCVGO's [4096, 1064], DMPIGO's [4096, 255], waymo's [2048, 96] and
     grass.py's [4096, 1064] and at a render chunk of each. ``cumdist_thres`` (DCVGO's oversample skip) must give the plain
     version's flags exactly, on DCVGO's own step distances at the train step's
     and a render chunk's shape, at ragged shapes and on adversarial distances
     (sums across its pieces and blocks, zero tails, distances exactly at and
     at half the threshold, a view 4 bytes into its storage). ``masked_adam``
     must give the plain version's p, m and v to the bit at every parameter
     shape of phases 4 to 9 (Truck.py's 2.73 G-element k0 and grass.py's
     f32 one bank by bank), without a grad (with and without the skip), at
     ragged sizes and on views that start inside a vector, and so with a
     per-element lr (phase 9's coarse density grid, ragged sizes, unaligned
     views); its bound counts the 32-byte DRAM sectors
     that hold a non-zero g (p's of 32 / element size, m's and v's of 8
     elements), which is what the memory moves (the count by element is
     printed beside it as ``bound_ms_elementwise``). The six gather-probe
     kernels (the vector and the row-loop forms of the two row gathers,
     ``box_gather8``, ``box_sum``) are driven through their entry point
     (``probes.gather.main``),
     which holds each against its plain version at every one of its shapes (indexed copies bit-equal, ``box_sum``
     within 1e-3 relative) and times it, always by many launches in one CUDA
     graph, and ``torch.index_select`` alike; a row gather's bound counts the
     source rows its indices touch, ``box_gather8``'s the 32-byte runs; that
     one run, counted from 0, also gives these kernels' launches;
  4. the scene and the trainer: a seeded synthetic 20-view 411x618 scene (the
     size of bicycle at factor 8) is written in the on-disk layout of a
     Mip-NeRF-360 capture (``poses_bounds.npy`` and ``images_8/*.png``) and
     loaded by the port's ``data.common.load_everything`` through a config
     whose ``_base_`` is ``configs/nerf_unbounded/bicycle_single.py``
     (spherify, every 8th view held out: 17 training views, 3 test views).
     Then the FourierGrid fine stage of that config, through ``run_train``,
     with its ``pg_scale`` boundaries, the schedule compressed to
     ``PG_SCALE`` = (3, 6): the grids start at 200^3 / 4 voxels, are
     upsampled at steps 3 and 6 (occupancy refreshed, optimizer rebuilt, lr
     back at its base), and every step from the last boundary on runs at the
     config's full width (7 banks of 199^3, k0 12 channels, bf16), where the
     step is timed. 10 steps by default; the analytic occupancy seed stands
     in for the coarse stage. Checked: the grid shapes after each boundary,
     the occupancy, the budget, ``lr_scale``, ``act_shift`` and the launch
     counts (``tv_add_grad`` 2 a step, both march kernels 1, ``masked_adam``
     as often as the optimizer should launch it: a spy on ``MaskedAdam.step``
     counts one a parameter, less a skip group's parameters without a grad;
     every train step of phases 4 to 9 is checked so). It saves the
     parameters as ``fine_last`` (without the optimizer's state: 6a saves
     that), then compares a forward on the card with the plain path on the
     CPU;
  4b. one boundary on the card against the same boundary on the CPU from one
     state (see ``phase_boundary``): there the refresh bites, a deferred
     sample budget comes on and Adam restarts;
  5. render: the checkpoint gets the synthetic scene's geometry imprinted
     (a few steps do not make a scene) and ``fast_color_thres`` takes its
     schedule's final value; then the command line renders it as a user
     does, ``--program render --render_test --ft_path <checkpoint>`` on the
     scene on disk (``load_everything``, ``load_model``,
     ``build_render_cache``, ``render_viewpoints``): the 3 held-out 411x618
     views in chunks of 8192 with ground truth, the first a warm-up.
     Checked: finite images; ``march_forward`` launched once per chunk and no
     other kernel at all; the two-stage cached render WITHOUT the density
     bake equals the uncached single-stage render (1e-4 relative) on every
     ray that did not overflow ``color_budget``; the cached render on the card
     equals the same path on the CPU for one chunk (the scene's occupancy:
     99.5% of the rays within 1e-4 relative, the rest being rays where the
     nearest-voxel lookup or a threshold rounds differently; all-true
     occupancy: at most 1e-5 of the samples pass ``fast_color_thres`` on one
     device only, the rays of such samples agree within two thresholds' worth and
     every other ray within 1e-5 + 1e-5 relative); the baked render's PSNR against
     the exact render is printed and held above ``BAKED_MIN_PSNR``;
  6a. the command line's ``train`` on the same scene and config, unseeded, as
     a user runs it (``python -m unboundednerfpytorch_tpu_torch.cli.main
     --config ...``), the boundaries compressed to ``CLI_PG_SCALE`` = (2, 3):
     run 1 trains 4 steps with ``--i_weights 2`` and renders the test views.
     Checked in the loop's own records (``fine_metrics.jsonl``): the sample
     budget held at 0 until the first boundary and switched on there, the
     cache all true before it; the periodic checkpoint at step 2 (after the
     first boundary, 158^3) and ``fine_last`` at step 4 (full width), both
     with the optimizer's state. Run 2 is
     the same command with ``N_iters`` two larger: it resumes at step 4 from
     ``fine_last``, the Adam step count and both moments restored bit-equal
     to what run 1 saved, the lr anchored at the last boundary, and trains
     two more full-width steps. The seconds and GB of each save and of a
     full-width load are printed;
  6b. ``configs/tankstemple_unbounded/truck_single.py``'s command-line
     ``train`` on a NeRF++-layout scene written the same way (8 training and
     2 test views of 546x980, OpenCV poses, ``inverse_y``): 8 steps, its
     seven boundaries compressed to ``CLI_PG_SCALE``, ending at full width (9
     banks of 199^3, ``N_rand`` 4096); ms/step at full width and peak memory.
     It writes no checkpoint, and nor do 7a and 8a (``cli_train_in_memory``,
     the disk kept for phase 13a, the save code held by 6a and 13a): the
     command line itself loads the data and writes ``args.txt``
     (``--program export_bbox``), ``run_train`` trains without an
     ``exp_dir`` (a callback keeps the loop's records), and the test views
     are rendered from the trained parameters as ``run_render`` renders a
     checkpoint's.
     Every command-line run is checked for its launches: ``tv_add_grad`` 2 a
     step, both march kernels 1 a step, ``march_forward`` once per chunk of
     the render that follows training;
  7. the other families and the host ray store, each at its config's full
     width, its boundaries compressed to ``CLI_PG_SCALE`` and
     ``FAMILY_STEPS`` steps: 7a ``configs/nerf_unbounded/bicycle.py`` (DCVGO,
     319^3 one-bank grids, k0 12 channels bf16, 1064 samples a ray), the
     command line's ``train`` on an 8-view capture at images_4 (822x1237), ending with
     the render of its one test view (``cumdist_thres`` too once a step and a
     chunk); then, on the trained model with the scene imprinted, the cached
     render's forward against the uncached one on a chunk and the card against
     the CPU on ``CPU_RAYS`` rays, threshold flips counted; 7b
     ``configs/llff/fern.py`` (DMPIGO, NDC rays, 256^3 voxels as [X, Y, 128],
     f32, rgbnet 9/64) through the command line on a 20-view forward-facing
     capture of 756x1008 in the LLFF layout, and the render of its test views;
     7c ``configs/tankstemple_unbounded/Truck.py`` (FourierGrid, seven banks of
     ~319^3, ``load2gpu_on_the_fly``) through ``run_train`` without a
     checkpoint, the rays in host memory: ms/step, peak memory (under the
     card's) and the host batch's share of a step;
  8. the Waymo and free-trajectory layouts, each config at its full width, its boundaries compressed to ``CLI_PG_SCALE``
     and ``FAMILY_STEPS`` steps: 8a ``configs/waymo/waymo_no_block.py``
     (seven banks of 299^3, k0 of 3 channels bf16, ``N_rand`` 2048, the
     96-sample budget and the 32-sample colour budget, the Fourier MSE loss,
     ``--diffuse``), the command line's ``train`` on a Waymo-layout capture
     (``metadata.json``; 8 training views of camera 73, 2 of camera 74 with
     another focal length, which the config's ``training_ids`` drop, 2 val
     views, 640x960), then the render of the 2 val views with PSNR and of the
     first ``WAYMO_TRAJECTORY`` of the 200 trajectory views without (the test
     split cut so by a spy on ``load_everything``); 8b
     ``configs/free_dataset/grass.py`` (seven banks of 319^3 in f32,
     ``N_rand`` 4096, every one of 1064 samples a ray: no sample or colour
     budget) on a free-trajectory capture (``cams_meta.npy``, 8 views stored
     at 1080x1920, 540x960 after the config's factor 2) loaded by
     ``load_everything``, trained by ``run_train`` without a checkpoint
     (35.4 GB with Adam's state; see the note at ``CLI_SAVE_EVERY``), then
     its test view rendered from the trained parameters as ``run_render``
     does: ms/step, peak memory, ms/view, the scene load's seconds and the
     launches of each kernel;
  9. the DVGO family with its coarse stage: 9a ``configs/nerf/lego.py``
     through the command line on a NeRF-synthetic capture (20 train, 2 val
     and 2 test views of 800x800 RGBA, written before phase 3, which holds
     the kernels at its shapes): ``train`` runs the coarse stage at its
     full 100^3 (``LEGO_COARSE_STEPS`` steps of the ``random`` sampler, with
     ``pervoxel_lr``, its per-element lr going through ``masked_adam``, and
     ``maskout_near_cam_vox``), then the fine stage on the box of the coarse
     geometry with its occupancy cache seeded from the coarse alpha and the
     ``in_maskcache`` rays, its four boundaries compressed to
     ``LEGO_PG_SCALE`` so that it ends at full width (160^3 voxels, k0 12
     channels, the 128-wide MLP, ``N_rand`` 8192), then renders the 2 test
     views; then ``--program export_coarse``. Checked: the launches (both
     march kernels once a step, ``masked_adam_per_lr`` once a coarse step,
     ``masked_adam`` as the optimizer should launch it, ``march_forward``
     once a render chunk), that the coarse stage found the seeded sphere
     (its last PSNR and the fine box), the fine grids at full width, the
     exported volume. Printed: ms/step of each stage, peak memory, the
     seconds of ``voxel_count_views`` and of the ``in_maskcache`` filter with
     the share of rays it kept, the fine box against the frustum's, ms per
     view. 9b ``configs/tankstemple/Truck_lg.py`` through ``run_train``
     without a checkpoint on a Tanks & Temples capture of 8 + 2 views of
     1920x1080 (the host ray store, ``pervoxel_lr_downrate`` 2): a few coarse
     steps, then the fine stage's six boundaries compressed so that it ends
     at 256^3; ms/step of each stage and peak memory;
 10. the paths of the last configs: 10a ``configs/linemod/ape.py`` through the
     command line on a seeded LINEMOD sequence (24 JPEG frames of 640x480,
     cropped to 90x90): ``train`` (the fine-only DVGO at 160^3 on the host
     store), the render of its test views, then ``--program linemod_eval``
     in its sanity mode (every metric 1.0) and on seeded predictions 2 cm
     off (the scores fall); 10b ``configs/co3d/teddybear.py`` through the
     command line on a seeded CO3D capture (21 frames of 800x600 and one
     with an empty mask): 1000 coarse steps, the fine stage to 160^3, one
     test view; 10c ``configs/nerf/ship.tensorf.py`` through ``run_train`` on
     9a's capture from a copy of 9a's ``coarse_last`` (the resume trains
     nothing in the coarse stage): the TensoRF fine stage, its six
     boundaries compressed, ending at 384^3, and one test view rendered
     without a cache; 10d ``configs/custom/Madoka.py`` (DMPIGO, factor 2,
     256^3 as [X, Y, 128]) through ``run_train`` on a seeded forward-facing
     capture at images_2: the coarse stage as the JAX package runs it (no
     maskout, no per-voxel lr, no filter), then the fine stage seeded from
     it (the seed must drop part of the fine lattice); 10e ``--program
     tune_pose`` on 10a's ``fine_last`` (ms per step, both march kernels
     once a step, the first step's delta gradient against the CPU's on the
     same pixels) and a recovery of perturbed poses on a DVGO trained on
     four textured spheres at different depths (both errors halved). 10b-10d
     fail unless the fine stage has live samples (the fine box inside the
     frustum's, the cache not empty after the last boundary). 10f holds both march kernels and
     ``masked_adam`` (with and without a per-element lr) against their plain
     versions at every shape phase 10 gave them, and times them;
 11. reference ``.tar`` checkpoints, ``--program sfm``, the held-out panels,
     the render server and ARF, on the models phases 4-10 trained: 11a
     exports 9a's lego model to a reference ``.tar`` (``export_checkpoint``),
     renders its test views with ``--program render --ft_path lego.tar``
     (equal to 9a's render within ``TAR_ATOL``, the reference storing its box
     as float32) and trains 3 steps from it with ``--program train
     --ft_path lego.tar`` (fresh moments); 11b takes phase 4's bicycle_single
     model through ``convert_to_reference``, ``torch.save`` into memory and
     back (every leaf equal, one render chunk within ``TAR_ATOL``); 11c
     ``--program tune_pose --ft_path ape.tar`` on 10a's model (the first
     step's delta gradient 10e's); 11d is 10d's capture written as a sparse
     COLMAP model whose poses ``--program sfm`` recovers (within 1e-5, the
     bounds on the ball's front and at the wall); 11e is 9a's panel
     (``i_panel``), its PSNR that of ``render_image`` of its view; 11f serves
     9a's checkpoint and the ``.tar`` with ``tools/serve.py`` on localhost
     (each PNG equal to ``render_image`` of its pose); 11g is phase 5's
     render with ``--style_root`` (colours that span three directions; the
     stylized set's colour mean and covariance the style image's); 11h
     holds the kernels at the shapes 11a and 11c gave them;
 12. FourierGrid's fast paths on phase 4's model as phase 5 left it (full
     width, the scene imprinted, ``fast_color_thres`` 1e-4), writing no
     checkpoint, each sub-phase printing one JSON line: 12a the hierarchical
     probe (``probe_coarse_stride`` 8) on test view 0: with a candidate
     group for every group its selection must equal the flat probe's on
     every ray, with the automatic count each ray's must be a prefix of it
     (the far tail truncated); the probe rows a ray and the view's ms with
     either probe; 12d the adaptive render (``render_rays_adaptive``
     through ``render_image``'s ``rays_fn``) against the two-stage cached
     render of the same view: within ``ADAPTIVE_ATOL`` on every ray but those
     with a sample on the other side of a threshold (counted), the live rays,
     the bucket and ms/view; the layout: the view through the packed
     single-stage tables and through the 8-corner gather
     (``packed_gather=False``); 12c phase 5's command-line render with
     ``--auto_budget``: the budgets, the occupancy, whether the hierarchical
     probe came on, ms/view against phase 5's and the PSNR against the full
     march (``AUTO_MIN_PSNR``); 12b one 2048-ray batch through the train step
     with the single-stage and the two-stage forward (``train_survivor_budget``
     48): the loss within 1e-4, every gradient by ``check_grad``; stage A's
     time; then timed steps of each, with ``color_overflow_frac``; 12e
     bicycle_single at full width with the coarse colour head, the view grid
     (63^3, what ``num_voxels_viewdir`` 64^3 gives) and the embeddings, 3
     steps each, the first two through the ``.tar`` format in memory, the
     third's export refused; 12f holds the march kernels and masked Adam at
     every shape phase 12 gave them ([2048, 48], the adaptive render's
     [262144, 96], the view grid, the embeddings, the coarse head's grids)
     and ``tv_add_grad`` at the coarse head's k0;
 13. the Waymo city-scale path: 13a the street scene (``street_scene``,
     14 views of 640x960, each with its exposure) written as the Waymo
     release's TFRecords (per-pixel rays, intrinsics, camera, exposure, PNG)
     and decoded by ``data/preprocess.py`` (each camera recovered from its
     rays), then ``configs/waymo/waymo_block.py --num_per_block 5`` through
     the command line: two blocks of the 10 camera-73 training views (the two
     of camera 74 dropped by its ``sample_cam``), each at the config's full
     width (seven banks of 299^3, k0 3 channels bf16), its boundaries
     compressed as in 8a, saved with Adam's state in ``block_<b>/``, as
     ``fine_last_<b>`` and merged into ``fine_last_merged`` (the grids the
     blocks' elementwise minimum to the bit, the occupancy cache a fresh
     refresh's); 13b ``--render_only`` through the merged checkpoint (val
     views with PSNR), and with it moved aside through ``run_render_blocks``
     (each block's views, each frame equal to the render of that block's
     checkpoint alone); 13c Block-NeRF at the reference's width (D=8, W=256,
     visibility 128, appearance 32, 64 + 64 samples, batch 1024,
     ``use_disp``) on the same records in two overlapping blocks
     (``split_blocks``, each block's capture by ``extract_block_meta``):
     ``BN_STEPS`` steps a block through ``tools.train_block_nerf`` (the fine
     PSNR must rise ``BN_MIN_GAIN`` dB), an overlap view composed through
     ``tools.eval_block_nerf``; 13d a chunk of 4096 rays and a step's
     gradients, card against CPU within ``BN_TOL``, and the composed frame
     against the host's blend of the same block renders; 13e both march
     kernels, masked Adam and ``tv_add_grad`` at every shape 13a and 13b gave
     them;
 14. multi-device parallelism on the one card: 14a the distributed code over
     a real NCCL group of one rank, opened in this process on a localhost
     TCP store: phase 4's model takes one ``DIST_N_RAND`` batch through the
     train step without a mesh and through the data-parallel step (the loss
     equal to the bit, every gradient by ``check_grad``), and the first test
     view renders through phase 5's render cache without a mesh and
     cooperatively (equal within 1e-6); 14b the sharded path at full width
     in one process, at the grids of 13a's steps whose X ``HALO_WAYS`` cuts
     (188^3 over 4 slabs, 238^3 over 2; bicycle_single's 199^3 stays whole,
     as in the JAX package), the exchange emulated by copying the neighbour
     planes: the halo sample's values and gradients against the unsharded
     sample, ``tv_add_grad``'s halo launches against their plain version and
     the slabs' TV, joined, against the whole grid's to the bit; the halo
     launches' times join ``tv_add_grad``'s shape lines in the kernel table
     (comparisons: they count on no path). Several cards are
     ``probes/multi_gpu.py``'s, under ``torchrun``.

``--profile`` also traces the last train steps and one rendered view with
``torch.profiler`` and prints the device time by range and by kernel.
``--kernels-only`` stops after phase 3 and prints the kernel table without
launch counts and without the last line (a quick check of a changed kernel).
The kernel table's launches are those of phases 4 to 14 and of the probe run.
Near the end it prints the seconds and the GiB written (``/proc/self/io``) by
phase: a chip call may write 45 GiB, deleted files included.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no result. It needs a CUDA device and the rest of
the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"
TRUCK_CONFIG = ROOT / "configs" / "tankstemple_unbounded" / "truck_single.py"

PROFILED_STEPS = 4
# bicycle_single's eight pg_scale boundaries (steps 2000 to 16000) compressed
# to two: the grids start at 200^3 / 4 voxels, double at each boundary, and
# every step from the last boundary on runs at the config's full width
PG_SCALE = (3, 6)
WARMUP_STEPS = 2  # after a boundary, before a step is timed
H, W = 411, 618  # bicycle at factor=8
RENDER_CHUNK = 8192  # the command line's chunk (render.renderer.DEFAULT_CHUNK)
# the synthetic scene: a sphere of this radius at the origin, cameras on an
# orbit of this radius (data/synthetic.py::orbit_scene)
SPHERE_RADIUS, CAM_RADIUS = 0.8, 3.0
# the command line (phase 6): both configs' boundaries compressed to two; 6a's
# first run saves at step 2 (after the first boundary, at 158^3) and ends at
# 4 (full width), its second at 6
CLI_PG_SCALE = (2, 3)
# The card's machine lets one run of the script write 45 GiB to its disk,
# deleted files included (its host counts every block written): the
# checkpoints of phases 4 to 9a come to about 42 GiB, so phase 4 saves no
# optimizer state, 6a saves periodically before full width and 8b and 9b
# save none
CLI_SAVE_EVERY, CLI_STEPS = 2, 4
# truck_single on a NeRF++ scene at the Tanks & Temples image size of the
# NeRF++ release: 8 training and 2 test views, 8 steps (6 to 8 timed)
TRUCK_H, TRUCK_W, TRUCK_VIEWS, TRUCK_TEST, TRUCK_STEPS = 546, 980, 8, 2, 8
# the density bake (one f32 bank at 2x) against the exact density on the
# imprinted scene, whose ball has an edge two voxels wide: the floor under
# which the bake would be broken rather than approximate
BAKED_MIN_PSNR = 30.0
# card against CPU: the share of a chunk's samples that may pass
# ``fast_color_thres`` on one device only (7 of a chunk's 786,432)
MAX_FLIPPED_SHARE = 1e-5
# phase 7: the DCVGO and DMPIGO families and the host ray store
DCVGO_CONFIG = ROOT / "configs" / "nerf_unbounded" / "bicycle.py"
FERN_CONFIG = ROOT / "configs" / "llff" / "fern.py"
TRUCK_HOST_CONFIG = ROOT / "configs" / "tankstemple_unbounded" / "Truck.py"
# 7a: bicycle at factor 4 (images_4), 8 views: 7 training views and one held
# out (llffhold=8), which the command line renders after training
BIKE4_H, BIKE4_W, BIKE4_VIEWS = 822, 1237, 8
# 7b: fern at factor 4, 20 views (views 0, 8 and 16 held out); the depths the
# capture stores as every view's bounds: the ball lies at 3 to 5, the wall at 8
FERN_H, FERN_W, FERN_VIEWS = 756, 1008, 20
FERN_BOUNDS = (2.5, 9.0)
# 7a-7c: steps, the boundaries compressed to CLI_PG_SCALE; the steps after the
# last boundary and WARMUP_STEPS are timed
FAMILY_STEPS = 7
# 7a: the card against the CPU on this many rays (1064 samples each)
CPU_RAYS = 512
# phase 8: the Waymo layout through the command line (8a) and the
# free-trajectory one through run_train (8b), each config at its full width,
# its boundaries compressed to CLI_PG_SCALE and FAMILY_STEPS steps
WAYMO_CONFIG = ROOT / "configs" / "waymo" / "waymo_no_block.py"
FREE_CONFIG = ROOT / "configs" / "free_dataset" / "grass.py"
# 8a: the Waymo cameras' 1920x1280 at the config's factor 2 (stored so: the
# loader does not resize); camera 73's training views (the config's
# training_ids keep 73_<i>), views of camera 74 (another focal length, which
# the ids drop) and val views
WAYMO_H, WAYMO_W, WAYMO_TRAIN, WAYMO_OTHER, WAYMO_VAL = 640, 960, 8, 2, 2
WAYMO_TRAJECTORY = 3  # of the 200 trajectory views, rendered without ground truth
# 8b: views stored at 1080x1920, 540x960 after grass.py's factor 2; every 8th
# held out
FREE_H, FREE_W, FREE_VIEWS, FREE_FACTOR = 540, 960, 8, 2
# phase 9: the DVGO family with its coarse stage. 9a: nerf/lego.py through
# the command line on a NeRF-synthetic capture of 20 train, 2 val and 2 test
# views of 800x800 RGBA (the real scene has 100/100/200); the coarse stage
# runs LEGO_COARSE_STEPS of its 5000 steps at its full 100^3: from alpha_init
# 1e-6 the density's gradients start under Adam's eps, and the geometry
# forms between steps 500 and 900 (PSNR 9 at step 500, 28 at 800, 32 at 900
# on the H100), so fewer steps leave nothing above bbox_thres and the fine
# box and the in_maskcache filter would take everything; the fine stage
# LEGO_FINE_STEPS of 20000 with its
# four boundaries compressed to LEGO_PG_SCALE, so that its last steps run at
# its full width (160^3 over the box of the coarse geometry, k0 12 channels,
# the 128-wide rgb MLP, N_rand 8192)
LEGO_CONFIG = ROOT / "configs" / "nerf" / "lego.py"
LEGO_H = LEGO_W = 800
LEGO_TRAIN, LEGO_HELD = 20, 2
LEGO_COARSE_STEPS, LEGO_FINE_STEPS, LEGO_PG_SCALE = 1000, 9, (2, 3, 4, 5)
LEGO_COARSE_MIN_PSNR = 25.0  # the coarse stage's last step, on the seeded sphere
LEGO_CAM_RADIUS, LEGO_FOCAL_SCALE = 4.0, 1.3889  # the NeRF-synthetic cameras: 4 from the
# origin, a focal length of 1111 pixels at 800 wide
# 9b: tankstemple/Truck_lg.py through run_train without a checkpoint on a
# Tanks & Temples capture of 8 + 2 views of 1920x1080: TRUCK_LG_COARSE_STEPS
# coarse steps (pervoxel_lr_downrate 2, the host ray store), enough for the
# geometry to form as in 9a, so that the fine stage runs on the coarse
# geometry's box with live samples; then the fine stage's six boundaries
# compressed to TRUCK_LG_PG_SCALE, ending at 256^3. Each boundary lowers
# act_shift by decay_after_scale (1.0), which the schedule's 1000 steps
# between boundaries let the density follow; six decays within six steps
# leave every alpha under fast_color_thres at the last refresh (the cache
# empties, and no sample is live at full width), so the compressed schedule
# takes TRUCK_LG_DECAY instead
TRUCK_LG_CONFIG = ROOT / "configs" / "tankstemple" / "Truck_lg.py"
TRUCK_LG_H, TRUCK_LG_W, TRUCK_LG_VIEWS, TRUCK_LG_TEST = 1080, 1920, 8, 2
TRUCK_LG_COARSE_STEPS, TRUCK_LG_FINE_STEPS = 1000, 11
TRUCK_LG_PG_SCALE = (2, 3, 4, 5, 6, 7)
TRUCK_LG_DECAY = 0.0
# phase 10: the LINEMOD pose path, CO3D, TensoRF and the DMPIGO coarse stage.
# Each compressed fine schedule takes COMPRESSED_DECAY for 9b's reason (a
# decay a boundary within a step of each other empties the occupancy cache)
LINEMOD_CONFIG = ROOT / "configs" / "linemod" / "ape.py"
CO3D_CONFIG = ROOT / "configs" / "co3d" / "teddybear.py"
SHIP_CONFIG = ROOT / "configs" / "nerf" / "ship.tensorf.py"
MADOKA_CONFIG = ROOT / "configs" / "custom" / "Madoka.py"
COMPRESSED_DECAY = 0.0
# 10a: 24 LINEMOD frames of 640x480 (4 test), cropped to 90x90; 9 fine steps,
# the four boundaries at steps 2-5, ending at 160^3
LM_FRAMES, LM_TEST, LM_STEPS, LM_PG_SCALE = 24, 4, 9, (2, 3, 4, 5)
# 10b: 20 + 1 CO3D frames of 800x600; the coarse stage as long as 9a's, for
# the geometry to form; the fine stage as 10a's
CO3D_FRAMES, CO3D_TEST, CO3D_H, CO3D_W = 21, 1, 800, 600
CO3D_COARSE_STEPS, CO3D_FINE_STEPS, CO3D_PG_SCALE = 1000, 9, (2, 3, 4, 5)
# 10c: the six boundaries at steps 2-7, ending at 384^3; one 800x800 test
# view, uncached: every sample of a ray goes through the TensoRF fields
SHIP_FINE_STEPS, SHIP_PG_SCALE = 11, (2, 3, 4, 5, 6, 7)
# 10d: Madoka at factor 2: 12 views of 540x960; DMPIGO's planes start at equal
# weight, so its coarse PSNR passes 30 within 50 steps, but the alpha of its
# free space sinks slowly (the median of the nearest plane 0.0049 at step 300,
# 0.0026 at 1000, over mask_cache_thres 1e-3): 1000 coarse steps, as 9a's,
# leave an occupancy seed that drops 3.5 % of the fine lattice, 300 only 0.2 %
MADOKA_H, MADOKA_W, MADOKA_VIEWS = 540, 960, 12
# 11d: the surface points of 10d's sparse model, and how near its poses must
# come to the scene's
MADOKA_POINTS, SFM_POSE_TOL = 4000, 1e-5
MADOKA_COARSE_STEPS, MADOKA_FINE_STEPS, MADOKA_PG_SCALE = 1000, 9, (2, 3, 4, 5)
# 10e: tune_pose steps through the command line; the card's first-step delta
# gradient against the CPU's: within TUNE_GRAD_TOL[0] of its largest element
# plus TUNE_GRAD_TOL[1] relative (as tests/test_torch_port_pose_tune.py holds
# the port against JAX). The recovery: four textured spheres at different
# depths (data/synthetic.py::cluster_scene, the layout of the JAX package's
# unbounded test scene) in RECOVER_VIEWS views of RECOVER_HW^2, a fine-only
# DVGO of RECOVER_VOXELS with the JAX pose-tuner test's MLP trained on it for
# RECOVER_TRAIN_STEPS steps of RECOVER_RAYS rays; the perturbation (degrees,
# share of the camera distance); RECOVER_STEPS tune steps of RECOVER_RAYS
# pixels at the JAX test's constant lr (annealed, as the command line's
# program runs, the sideways error stalls); the pixels the objective is read on
TUNE_STEPS = 10
TUNE_GRAD_TOL = (1e-3, 1e-2)
RECOVER_VIEWS, RECOVER_HW, RECOVER_VOXELS, RECOVER_TRAIN_STEPS = 20, 96, 64**3, 600
RECOVER_DEG, RECOVER_SHIFT = (1.0, 3.0), (0.01, 0.03)
RECOVER_STEPS, RECOVER_LR, RECOVER_RAYS, RECOVER_PIXELS = 1000, 3e-3, 4096, 32768
# phase 11: reference .tar checkpoints, the panels, sfm, the server and ARF.
# An imported model against its native one: the reference stores its box,
# scene centre and radius as float32, so the imported model samples at
# points a few ulps away (and a FourierGrid one holds as float32 the values
# of bicycle_single's bfloat16 grids): each ray's colour within TAR_ATOL, but
# for at most TAR_FLIP_SHARE of the rays (a sample that crosses
# fast_color_thres). TAR_TRAIN_STEPS: 11a's train and 11c's tune_pose from a
# .tar. 11f: SERVE_POSES (theta, phi in degrees) at SERVE_W x SERVE_H. 11g: a
# seeded style image of STYLE_H x STYLE_W, Gaussian about STYLE_MEAN with
# STYLE_STD, narrow enough that the transfer of phase 5's views needs no
# clipping. Those views' colours must span three directions (each eigenvalue
# of their covariance over ARF_RANK_FLOOR, 100 times the transfer's clamp of
# the singular values at 1e-8), so that every column of the 3x3 transform
# is used; the stylized set then takes the style image's mean (within
# ARF_MEAN_TOL) and its covariance (within ARF_COV_REL of the style's
# largest entry). The rank-deficient case is a CPU test
# (tests/test_torch_port_panels_serve.py).
TAR_ATOL, TAR_FLIP_SHARE, TAR_TRAIN_STEPS = 1e-4, 1e-3, 3
SERVE_POSES, SERVE_W, SERVE_H = ((0.0, -15.0), (120.0, 10.0), (240.0, 30.0)), 400, 300
STYLE_H, STYLE_W, STYLE_MEAN, STYLE_STD = 600, 800, (0.45, 0.5, 0.55), 0.08
ARF_MEAN_TOL, ARF_COV_REL, ARF_RANK_FLOOR = 1e-4, 0.01, 1e-6
# phase 12: FourierGrid's fast paths on phase 4's model as phase 5 left it
# (7 banks of 199^3 bf16, 96 of 664 samples, fast_color_thres 1e-4). 12a: the
# hierarchical probe's coarse stride; 12d: the adaptive render's first
# segment (the JAX default) and how near its view must come to the two-stage
# render's, a ray with a flipped threshold excepted; 12c: the floor of the
# --auto_budget render's PSNR against the full march (no budgets, no bake),
# the bake's own floor, since the config bakes the density; 12b: the
# survivor budget, batch and timed steps of the two-stage training forward;
# 12e: the view grid's voxels (64^3), the embeddings' width, the steps and
# the new groups' lrs (the grids' lr for the view grid)
FAST_PROBE_STRIDE, ADAPTIVE_SEG, ADAPTIVE_ATOL = 8, 32, 1e-5
AUTO_MIN_PSNR = BAKED_MIN_PSNR
FAST_SURVIVORS, FAST_N_RAND, FAST_STEPS = 48, 2048, 5
HEAD_VIEWDIR, HEAD_EMB_DIM, HEAD_STEPS = 64**3, 16, 3
HEAD_LRATES = dict(lrate_vd=0.1, lrate_img_embeddings=0.01)
# 12c's full march on every 4th ray of the view; 12e pickles a .tar dict
# under this size (11b times the pickling of a 2.9 GB one)
AUTO_PSNR_STRIDE, TAR_PICKLE_BYTES = 4, 1 << 30
# phase 13: the Waymo city-scale path. 13a: BLOCK_VIEWS views of the street
# scene at 8a's 640x960 as the Waymo release's TFRecords (the validation
# file's views BLOCK_VAL_IDS, camera 74's BLOCK_OTHER_IDS, which the config's
# sample_cam 73 drops), decoded by data/preprocess.py, trained by
# waymo_block.py with --num_per_block NUM_PER_BLOCK: two blocks of the 10
# camera-73 training views; 13c: the same records split into two
# overlapping Block-NeRF blocks (split_blocks at BN_RADIUS, BN_OVERLAP),
# BN_STEPS steps a block through the entry point, the fine PSNR (the mean of
# the first and of the last BN_PSNR_WINDOW steps) rising at least
# BN_MIN_GAIN dB; 13d: a chunk of BN_RAYS rays and a step's gradients, card
# against CPU within BN_TOL of the largest value (f32 with TF32 off on both:
# the products sum in another order and sin, cos, exp and log round
# otherwise by an ulp or two, which 16 linear layers and encoding phases up
# to 2^9 times the coordinates grow to some 1e-5; BN_TOL leaves a margin),
# but for the rays whose fine depths fall in another bin (at most
# BN_MAX_FLIPPED of them: some 65 x 62 u-cdf pairs a ray, each within 1e-7
# of a crossing with a chance of about 1e-5)
BLOCK_CONFIG = ROOT / "configs" / "waymo" / "waymo_block.py"
BLOCK_VIEWS, BLOCK_VAL_IDS, BLOCK_OTHER_IDS, NUM_PER_BLOCK = 14, (4, 9), (2, 11), 5
BN_RADIUS, BN_OVERLAP, BN_STEPS, BN_MIN_GAIN, BN_PSNR_WINDOW = 3.0, 0.3, 300, 3.0, 20
BN_RAYS, BN_TOL, BN_MAX_FLIPPED = 4096, 1e-3, 0.01
# phase 14: multi-device parallelism on one card. 14a: phase 4's step and a
# phase-5 view through the distributed code over a real NCCL group of one
# rank (DIST_N_RAND rays); 14b: the sharded path at full width in one
# process, on the grid shapes 13a's steps reached that HALO_WAYS divides
# (X -> ranks; bicycle_single's 199^3 divides by none and stays whole, as
# in the JAX package), the exchange emulated by copying the neighbour
# planes: the halo sample of HALO_QUERIES points a bank (f32 grids of the
# path's channels, values within 1e-6 of the largest, gradients by
# check_grad) and tv_add_grad's halo launches
DIST_N_RAND = 4096
HALO_WAYS, HALO_QUERIES = {188: 4, 238: 2}, 1 << 18
# kernel launches of a train step and of a render chunk, by family
TRAIN_PER_STEP = {"tv_add_grad": 2, "march_forward": 1, "march_backward": 1}
DCVGO_PER_STEP = {**TRAIN_PER_STEP, "cumdist_thres": 1}
DCVGO_PER_CHUNK = ("march_forward", "cumdist_thres")


def log(msg: str) -> None:
    print(msg, flush=True)


def written_gib() -> float | None:
    """GiB this process has handed to write calls so far (``wchar`` of
    ``/proc/self/io``: files, and the little it prints), None where the
    kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            fields = dict(line.split(":") for line in f)
    except OSError:
        return None
    return int(fields["wchar"]) / 2**30


class Spy:
    """For a ``with`` block, ``owner.name`` runs through a wrapper that calls
    the real function and records each call in ``calls`` as a namespace of
    ``args``, ``kwargs``, ``result`` and ``seconds`` (unless ``keep`` is
    False: the record holds the call's arguments alive); ``before(args,
    kwargs)`` and ``after(call)`` run around it. It reads what the command
    line's modules do without changing what they do."""

    def __init__(self, owner, name: str, before=None, after=None, keep: bool = True):
        self.owner, self.name, self.before, self.after = owner, name, before, after
        self.keep = keep
        self.calls = []

    def __enter__(self):
        real = self.real = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            if self.before is not None:
                self.before(args, kwargs)
            t0 = time.perf_counter()
            result = real(*args, **kwargs)
            call = argparse.Namespace(args=args, kwargs=kwargs, result=result,
                                      seconds=time.perf_counter() - t0)
            if self.keep:
                self.calls.append(call)
            if self.after is not None:
                self.after(call)
            return result

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


class Tee(io.TextIOBase):
    """Standard output that is also kept: ``lines`` after the block."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, text):
        self.text.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    @property
    def lines(self):
        return "".join(self.text).splitlines()


class AdamWanted:
    """A spy's ``before`` for ``MaskedAdam.step``: counts in ``n`` the
    launches of ``masked_adam`` that each step should make, one per parameter
    tensor of the optimizer's groups, less the empty ones and a skip group's
    tensors without a grad (nothing of those changes, so nothing is
    launched for them); a tensor with a per-element lr (``pervoxel_lr``) is
    always updated, and counted in ``n_lr`` instead (``masked_adam_per_lr``)."""

    def __init__(self):
        self.n = self.n_lr = 0

    def __call__(self, args, kwargs):
        opt = args[0]
        for g in opt.groups:
            for p in g.params:
                if p in opt.per_lr:
                    self.n_lr += 1
                elif p.numel() and not (g.skip_zero_grad and p.grad is None):
                    self.n += 1


ADAM_WANTED = AdamWanted()
# what a phase hands a later one: 9a's rendered test views and its panel,
# 10e's first tune step (its pixel picks and delta gradient)
SHARED = {}


def reset_counts() -> None:
    """Every kernel's launch count, and the optimizer's wanted launches, to 0."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    build.reset_launch_counts()
    ADAM_WANTED.n = ADAM_WANTED.n_lr = 0


def adam_wanted(tag: str, steps: int) -> int:
    """The launches of ``masked_adam`` that the steps since ``reset_counts``
    should have made: at least one a step."""
    if ADAM_WANTED.n < steps:
        raise AssertionError(f"{tag}: {steps} optimizer steps wanted {ADAM_WANTED.n} launches "
                             "of masked_adam")
    return ADAM_WANTED.n


def run_cli(argv) -> list:
    """``cli.main(argv)`` on the card, as ``python -m
    unboundednerfpytorch_tpu_torch.cli.main`` runs it; returns what it
    printed, line by line."""
    from unboundednerfpytorch_tpu_torch.cli import main as cli

    log(f"[cli] {' '.join(argv)}")
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        if cli.main(argv) != 0:
            raise AssertionError(f"the command line returned non-zero: {argv}")
    return tee.lines


def write_config(path: pathlib.Path, base: pathlib.Path, datadir, basedir, steps: int) -> str:
    """A scene config as a user writes one for a capture: the repository's
    config as ``_base_``, the capture and the log directories, and the
    run's length with the boundaries compressed to ``CLI_PG_SCALE``."""
    path.write_text(f"_base_ = {str(base)!r}\nbasedir = {str(basedir)!r}\n"
                    f"data = dict(datadir={str(datadir)!r})\n"
                    f"fine_train = dict(N_iters={steps}, pg_scale={list(CLI_PG_SCALE)})\n")
    return str(path)


def read_records(exp_dir) -> list:
    """The loop's own record of a stage (``fine_metrics.jsonl``)."""
    with open(os.path.join(exp_dir, "fine_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def dir_gb(path) -> float:
    return sum(f.stat().st_size for f in pathlib.Path(path).iterdir()) / 1e9


def launches_since(before: dict) -> dict:
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    diff = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()}
    return {k: v for k, v in diff.items() if v}


def sphere_radius_of(data) -> float:
    """The synthetic sphere's radius in a loaded scene's frame: the loader
    rotates and scales the orbit about the sphere's centre (the origin), so
    the cameras' distance from it gives the scale."""
    import numpy as np

    cam = np.linalg.norm(np.asarray(data["poses"])[:, :3, 3], axis=-1)
    return SPHERE_RADIUS * float(cam.mean()) / CAM_RADIUS


def check(name: str, got, ref, rtol: float, atol: float) -> float:
    """max |got - ref| must be <= atol + rtol * max |ref| (sums are taken in
    another order by kernel and plain version). Returns the max error."""
    import torch

    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - ref).abs().max())
    tol = atol + rtol * float(ref.abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def check_each(name: str, got, ref, rtol: float, atol: float) -> float:
    """Every element: |got - ref| <= atol + rtol * |ref|, where ``ref`` is
    the plain version's float32 result. For a bfloat16 ``got`` the bound is
    half a bfloat16 step of ``ref`` (the one rounding the kernel's store may
    add) plus ``rtol * |ref|`` for the float32 sum order. Returns the max
    error."""
    import torch

    rounded = got.dtype == torch.bfloat16
    got = got.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - ref).abs()
    tol = atol + rtol * ref.abs()
    if rounded:  # |ref| = m * 2^e, 0.5 <= m < 1: a bfloat16 step there is 2^(e-8)
        tol += torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 9)
    err = float(diff.max())
    worst = float((diff / tol).max())
    log(f"  {name}: max_abs_err {err:.3e}, worst error / its element's tolerance {worst:.3f}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: an element exceeds its tolerance ({worst} x)")
    return err


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    t0 = time.time()
    logs = build.build(ptxas_verbose=True)
    log(f"[2] built {sorted(build.SOURCES)} in {time.time() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def slice_config(steps: int):
    """bicycle_single with its fine stage cut to ``steps`` steps and its
    pg_scale schedule compressed to ``PG_SCALE``."""
    from unboundednerfpytorch_tpu_torch.configs import loader

    cfg = loader.load_config(str(CONFIG))
    return dataclasses.replace(
        cfg, fine_train=dataclasses.replace(cfg.fine_train, pg_scale=PG_SCALE, N_iters=steps))


def slice_shapes(cfg):
    """The shapes the train step hands the kernels: the density and k0 grids
    [2K+1, X, Y, Z, C] (the world size does not depend on the scene box) and
    the [N_rand, sample_budget] march."""
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg

    fm = cfg.fine_model_and_render
    mcfg = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density,
                          fm.num_voxels_rgb)
    banks = 2 * mcfg.fourier_freq_num + 1
    tv_shapes = {"k0": (banks, *mcfg.world_size_rgb, mcfg.k0_dim),
                 "density": (banks, *mcfg.world_size_density, 1)}
    march = (cfg.fine_train.N_rand, mcfg.sample_budget)
    return tv_shapes, march, mcfg.act_shift, mcfg.stepsize * mcfg.voxel_size_ratio_density


# shapes that break a design built on 16-byte vectors: rows, planes and banks
# that are no multiple of a vector, one element, a tensor smaller than a vector
TV_RAGGED_SHAPES = ((2, 7, 9, 11, 1), (3, 5, 7, 199, 12), (1, 1, 1, 1, 1), (1, 2, 1, 3, 5))
# S of 1, under, over and far over a warp's 32 lanes and the backward's group
# of 96, N no multiple of the eight rays of a block, no ray at all
MARCH_RAGGED_SHAPES = ((37, 17), (5, 200), (1, 1), (0, 96), (37, 1), (13, 31), (37, 33),
                       (37, 96), (11, 130))


def shape_line(what: str, ms: float, call_ms: float, bnd: float, floor: float) -> dict:
    """Log one launch shape's times; the yardstick is max(bound, floor)."""
    share = max(bnd, floor) / ms
    log(f"[3] {what}: device {ms:.4f} ms a launch ({call_ms:.4f} ms a call through the "
        f"wrapper), bound {bnd:.5f} ms, launch floor {floor:.5f} ms, "
        f"max(bound, floor) / ms = {100 * share:.1f}%")
    return {"shape": what, "ms": ms, "call_ms": call_ms, "bound_ms": bnd, "floor_ms": floor,
            "share_of_max_bound_floor": share}


def check_within(name: str, got, ref, tol) -> float:
    """Every element: |got - ref| <= its entry of the tensor ``tol``. Returns
    the max error."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - ref).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    worst = float((diff / tol).max()) if diff.numel() else 0.0
    log(f"  {name}: max_abs_err {err:.3e}, worst error / its element's tolerance {worst:.3f}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: an element exceeds its tolerance ({worst} x)")
    return err


def tv_case(gen, label, shape, dtype, w) -> float:
    """One shape and dtype of ``tv_add_grad`` against the plain version: gate 0
    and 1, sparse and dense, out of place and in place. Returns the max error."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv

    err = 0.0
    p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda")
    g = (g * (torch.rand(shape, generator=gen, device="cuda") > 0.4)).to(dtype)
    for gate in (0.0, 1.0):
        for dense in (False, True):
            got = tv.tv_add_grad(p, g, *w, gate, dense)
            # float32 result of the same inputs, before any bf16 store
            ref = tv.tv_add_grad_plain(p.float(), g.float(), *w, gate, dense)
            torch.cuda.synchronize()
            err = max(err, check_each(
                f"tv {label} {tuple(shape)} {str(dtype)[6:]} gate={gate:g} "
                f"dense={dense}", got, ref, 1e-5, 1e-6))
            del ref
            if gate == 1.0:  # in place, as the train step calls it
                g2 = g.clone()
                if tv.tv_add_grad(p, g2, *w, gate, dense, out=g2) is not g2:
                    raise AssertionError("tv_add_grad(out=grad) returned another tensor")
                torch.cuda.synchronize()
                if not torch.equal(g2, got):
                    raise AssertionError(f"tv {label} {tuple(shape)} {dtype} dense={dense}: "
                                         "in place differs from out of place")
                del g2
            del got
    return err


def tv_views_case(gen, shape, dtype, w) -> float:
    """Tensors that start 1, 3 and 2 elements past an aligned address (views
    of larger buffers), so that param, grad and out are each aligned otherwise,
    and the kernel of one thread an element forced on the same inputs."""
    import math

    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv

    n = math.prod(shape)
    bufs = [torch.randn(n + 8, generator=gen, device="cuda").to(dtype) for _ in range(3)]
    p, g, out = (b[o:o + n].view(shape) for b, o in zip(bufs, (1, 3, 2)))
    ref = tv.tv_add_grad_plain(p.float(), g.float(), *w, 1.0, False)
    name = f"tv views {tuple(shape)} {str(dtype)[6:]}"
    tv.tv_add_grad(p, g, *w, 1.0, False, out=out)
    torch.cuda.synchronize()
    err = check_each(f"{name}, out aligned otherwise than grad", out, ref, 1e-5, 1e-6)
    g2 = g.clone()  # a fresh allocation: aligned
    tv._launch(p, g2, g2, *w, 1.0, False, simple=True)
    torch.cuda.synchronize()
    return max(err, check_each(f"{name}, one thread an element, in place", g2, ref, 1e-5, 1e-6))


def phase_tv(gen, tv_shapes, floor: float, truck_shapes: dict) -> dict:
    """``tv_shapes``: bicycle_single's grids, checked in bf16 and f32 and
    timed for the entry; ``truck_shapes``: truck_single's 9-bank grids
    (phase 6b), checked in bf16 and timed apart."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms, time_ms

    w = (0.3, 0.2, 0.1)
    err = 0.0
    for shape in TV_RAGGED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            err = max(err, tv_case(gen, "ragged", shape, dtype, w),
                      tv_views_case(gen, shape, dtype, w))
    main, shapes = {}, []
    for tag, path_shapes, dtypes in (("", tv_shapes, (torch.bfloat16, torch.float32)),
                                     ("truck ", truck_shapes, (torch.bfloat16,))):
        for label, shape in path_shapes.items():
            for dtype in dtypes:
                err = max(err, tv_case(gen, tag + label, shape, dtype, w))
                torch.cuda.empty_cache()
            # the train step's case: bf16, dense, in place
            p = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            ms, call_ms = kernel_ms(lambda: tv.tv_add_grad(p, g, *w, 1.0, True, out=g))
            rec = (ms, time_ms(lambda: tv.tv_add_grad_plain(p, g, *w, 1.0, True), iters=5),
                   3 * p.numel() * p.element_size(), 25 * p.numel())
            if not tag:
                main[label] = rec
            shapes.append(shape_line(f"tv_add_grad {tag}{label} {tuple(shape)} bf16 in place",
                                     ms, call_ms, bound_ms(*rec[2:])[0], floor))
            del p, g
            torch.cuda.empty_cache()
    ms = sum(v[0] for v in main.values())
    plain = sum(v[1] for v in main.values())
    bnd, by = bound_ms(sum(v[2] for v in main.values()), sum(v[3] for v in main.values()))
    log(f"[3] tv_add_grad per step (k0 + density, bf16): {ms:.3f} ms, plain {plain:.3f} ms, "
        f"bound {bnd:.3f} ms ({by}): {100 * bnd / ms:.1f}% of the bound")
    return {"name": "tv_add_grad", "route": "cuda",
            "source": "unboundednerfpytorch_tpu_torch/csrc/tv.cu",
            "replaces": "unboundednerfpytorch_tpu/ops/pallas/tv.py:137",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": None, "floor_ms": floor, "shapes": shapes}


def march_inputs(gen, shape):
    """[N, S] densities: a third of the rays opaque (the early exit
    fires), a third empty, a third mixed; a fifth of the samples masked. Every
    seventh ray ends at its first sample (no other is processed), and every
    seventh has its far half masked off."""
    import torch

    N, S = shape
    d = torch.randn((N, S), generator=gen, device="cuda") * 3.0
    kind = torch.arange(N, device="cuda") % 3
    d = torch.where((kind == 0)[:, None], d + 12.0, d)
    d = torch.where((kind == 1)[:, None], d - 15.0, d)
    mask = torch.rand((N, S), generator=gen, device="cuda") > 0.2
    d[::7, 0] = 30.0
    mask[::7, 0] = True
    mask[1::7, S // 2 + 1:] = False
    return d, mask


def check_march_forward(name: str, got, d, mask, shift: float, interval: float) -> float:
    """(weights, alphainv, alpha, t_excl) of the forward kernel against the
    plain version. The kernel multiplies the transmittance in another order
    than the plain ``cumprod``, so a sample whose transmittance lies within
    rounding of the early-exit threshold may be processed by one of them only:
    such samples are counted (at most ``MAX_FLIPPED_SHARE`` of all, each within
    1e-5 relative of the threshold), their rays held to two thresholds' worth,
    and every other ray to 1e-5 relative + 1e-6. Returns the max error of the
    rays without a flip."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
    from unboundednerfpytorch_tpu_torch.ops.cuda import march

    w, ai, alpha, t_excl = got
    N, S = d.shape
    if (w.shape, ai.shape, alpha.shape, t_excl.shape) != ((N, S), (N,), (N, S), (N, S)):
        raise AssertionError(f"{name}: output shapes {w.shape} {ai.shape} {alpha.shape} "
                             f"{t_excl.shape}")
    if N == 0:
        log(f"  {name}: no rays, shapes only")
        return 0.0
    w_ref, ai_ref, alpha_ref = march.fused_alpha2weights_plain(d, mask, shift, interval)
    t_ref = torch.cat([torch.ones_like(alpha_ref[:, :1]),
                       torch.cumprod(1.0 - alpha_ref, -1)[:, :-1]], -1)
    thres = alpha_ops.EARLY_EXIT_T
    flipped = (t_excl >= thres) != (t_ref >= thres)
    n_flipped = int(flipped.sum())
    if n_flipped:
        log(f"  {name}: {n_flipped} of {flipped.numel()} samples fall on the other side of "
            f"the early-exit threshold, on {int(flipped.any(-1).sum())} rays")
        if n_flipped > max(1, MAX_FLIPPED_SHARE * flipped.numel()):
            raise AssertionError(f"{name}: {n_flipped} threshold flips")
        if float((t_ref[flipped] - thres).abs().max()) > 1e-5 * thres:
            raise AssertionError(f"{name}: a flipped sample is not within rounding of the "
                                 "threshold")
    same = ~flipped.any(-1)
    err = 0.0
    for what, g, r in (("weights", w, w_ref), ("alphainv_last", ai, ai_ref),
                       ("alpha", alpha, alpha_ref), ("t_excl", t_excl, t_ref)):
        err = max(err, check(f"{name} {what}", g[same], r[same], 1e-5, 1e-6))
        if n_flipped:
            check(f"{name} {what}, rays of a flipped sample", g[~same], r[~same], 0.0, 2 * thres)
    return err


def phase_march(gen, shape, shift: float, interval: float, floor: float,
                 truck_shape: tuple) -> list:
    """``shape``: bicycle_single's train step, timed; ``truck_shape``:
    truck_single's (phase 6b), checked with the ragged shapes."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import march
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms

    def no_grad_forward(d, mask):  # what the render path calls
        with torch.no_grad():
            return march.fused_alpha2weights(d, mask, shift, interval)

    def backward_check(name, d, mask, res):
        """The kernel against the plain version: it sums gw * w in another
        order, which ``march_backward_tolerance`` allows for element by element (1e-5 of
        the terms of g_alpha before they cancel, with the ray's sum of
        |gw w| + |gl alphainv| standing for every partial sum; 1e-7 absolute)."""
        w, ai, alpha, t_excl = res
        gw = torch.randn(d.shape, generator=gen, device="cuda")
        gl = torch.randn(d.shape[:1], generator=gen, device="cuda")
        args = (alpha, t_excl, ai, gw, gl, shift, interval, d, mask)
        gd_ref = march.march_backward_plain(*args)
        tol = march.march_backward_tolerance(*args)
        gd = march.march_backward(*args)
        torch.cuda.synchronize()
        return gw, gl, check_within(name, gd, gd_ref, tol)

    err_f = err_b = 0.0
    for rshape in MARCH_RAGGED_SHAPES + ((RENDER_CHUNK, shape[1]), truck_shape):
        d, mask = march_inputs(gen, rshape)
        res = march.march_forward(d, mask, shift, interval)
        torch.cuda.synchronize()
        err_f = max(err_f, check_march_forward(f"march_forward {list(rshape)}", res, d, mask,
                                               shift, interval))
        # without a gradient the forward keeps no t_excl: same values otherwise
        lean = no_grad_forward(d, mask)
        torch.cuda.synchronize()
        for a, b in zip(lean, (res[0], res[1], res[2])):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"march_forward {list(rshape)}: the no-grad forward "
                                     "differs from the one that keeps residuals")
        if rshape[0]:
            err_b = max(err_b, backward_check(f"march_backward {list(rshape)}", d, mask, res)[2])

    N, S = shape
    d, mask = march_inputs(gen, shape)
    res = march.march_forward(d, mask, shift, interval)
    torch.cuda.synchronize()
    exits = int((res[3][:, -1] < 1e-3).sum())
    log(f"[3] march inputs: {exits} of {N} rays exit early")
    if exits == 0:
        raise AssertionError("march inputs never reach the early exit")
    err_f = max(err_f, check_march_forward(f"march_forward {[N, S]}", res, d, mask, shift,
                                           interval))
    w, ai, alpha, t_excl = res
    gw, gl, e = backward_check(f"march_backward {[N, S]}", d, mask, res)
    err_b = max(err_b, e)

    ns = N * S
    f_ms, f_call = kernel_ms(lambda: march.march_forward(d, mask, shift, interval), iters=50)
    f_plain = kernel_ms(lambda: march.fused_alpha2weights_plain(d, mask, shift, interval),
                        iters=50)[0]
    b_ms, b_call = kernel_ms(lambda: march.march_backward(alpha, t_excl, ai, gw, gl, shift,
                                                          interval, d, mask), iters=50)
    b_plain = kernel_ms(lambda: march.march_backward_plain(alpha, t_excl, ai, gw, gl, shift,
                                                           interval, d, mask), iters=50)[0]
    # forward with residuals: read density + mask, write weights, alpha, t_excl
    # and alphainv; backward: read alpha, t_excl, gw, density, mask, alphainv,
    # gl, write gd
    f_bnd, f_by = bound_ms(ns * (4 + 1 + 3 * 4) + N * 4, 25 * ns)
    shapes = [shape_line(f"march_forward at the train step's {[N, S]}, residuals kept", f_ms,
                         f_call, f_bnd, floor)]
    log(f"[3]   plain version {f_plain:.4f} ms")

    # the render path launches the forward under no_grad at one chunk of rays:
    # no t_excl is written, so the bound counts two [N, S] outputs
    Nr = RENDER_CHUNK
    dr, mr = march_inputs(gen, (Nr, S))
    r_ms, r_call = kernel_ms(lambda: no_grad_forward(dr, mr), iters=50)
    r_plain = kernel_ms(lambda: march.fused_alpha2weights_plain(dr, mr, shift, interval),
                        iters=50)[0]
    r_bnd, _ = bound_ms(Nr * S * (4 + 1 + 2 * 4) + Nr * 4, 25 * Nr * S)
    shapes.append(shape_line(f"march_forward at a render chunk's {[Nr, S]}, no gradient", r_ms,
                             r_call, r_bnd, floor))
    log(f"[3]   plain version {r_plain:.4f} ms")
    b_bnd, b_by = bound_ms(ns * (4 * 4 + 1 + 4) + 2 * N * 4, 30 * ns)
    b_shape = shape_line(f"march_backward {[N, S]}", b_ms, b_call, b_bnd, floor)
    log(f"[3]   plain version {b_plain:.4f} ms")
    src = "unboundednerfpytorch_tpu_torch/csrc/march.cu"
    # the forward's entry sums its two shapes, one launch each
    return [
        {"name": "march_forward", "route": "cuda", "source": src,
         "replaces": "unboundednerfpytorch_tpu/ops/pallas/march.py:161", "max_abs_err": err_f,
         "ms": f_ms + r_ms, "plain_ms": f_plain + r_plain, "bound_ms": f_bnd + r_bnd,
         "bound_by": f_by, "library_ms": None, "floor_ms": floor, "shapes": shapes},
        {"name": "march_backward", "route": "cuda", "source": src,
         "replaces": "unboundednerfpytorch_tpu/ops/pallas/march.py:197", "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bnd, "bound_by": b_by,
         "library_ms": None, "floor_ms": floor, "shapes": [b_shape]},
    ]


# the TPU kernel site that each gather-probe kernel replaces
PROBE_REPLACES = {
    "gather_tile_rows": "tools/probe_dynamic_gather.py:50",
    "gather_tile_rows_loop": "tools/probe_kernel_gather.py:54",
    "gather_rows": "tools/probe_pallas_gather.py:53",
    "gather_rows_loop": "tools/probe_pallas_gather.py:81",
    "box_gather8": "tools/probe_vreg_gather.py:72",
    "box_sum": "tools/probe_kernel_gather.py:119",
}


# the row loops of bulk copies beyond the probe's shapes: rows of 16, 48, 256
# and 512 bytes, N no multiple of a stage's rows (N, and tile or 0)
LOOP_EDGE_ROWS = (("float32", 4), ("bfloat16", 24), ("bfloat16", 128), ("float32", 128))
LOOP_EDGE_SHAPES = ((1, 0), (17, 0), (4001, 0), (1037, 100), (7, 7), (64 * 9 + 5, 64))


def loop_edge_cases() -> int:
    """Each row-loop kernel bit-equal to its plain version at
    ``LOOP_EDGE_ROWS`` x ``LOOP_EDGE_SHAPES`` with int32 and int64 indices,
    a seventh of them out of range, and on a table view that starts inside
    its storage on a 16-byte boundary; a 24-byte row and a view off a 16-byte
    boundary refused. Returns the cases held."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import gather_probe as gp

    gen = torch.Generator(device="cuda").manual_seed(3)
    held = 0
    for dtype, C in LOOP_EDGE_ROWS:
        for n, tile in LOOP_EDGE_SHAPES:
            for idx_dtype in (torch.int32, torch.int64):
                rows = n if tile else 300
                buf = torch.randn(((rows + 1) * C,), generator=gen, device="cuda").to(
                    getattr(torch, dtype))
                table = buf[C:].view(rows, C)  # one row into its storage
                hi = tile or rows
                idx = torch.randint(-3, hi + 3, (n,), generator=gen, device="cuda",
                                    dtype=idx_dtype)
                if tile:
                    got = gp.gather_tile_rows_loop(table, idx, tile)
                    want = gp.gather_tile_rows_plain(table, idx, tile)
                else:
                    got = gp.gather_rows_loop(table, idx)
                    want = gp.gather_rows_plain(table, idx)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"row loop {dtype} C={C} n={n} tile={tile} "
                                         f"{idx_dtype}: kernel and plain version disagree")
                held += 1
    idx = torch.zeros(4, dtype=torch.int32, device="cuda")
    for bad in (torch.zeros((8, 12), dtype=torch.bfloat16, device="cuda"),
                torch.zeros(66, device="cuda")[2:].view(8, 8)):
        try:
            gp.gather_rows_loop(bad, idx)
        except ValueError:
            continue
        raise AssertionError(f"gather_rows_loop took a {tuple(bad.shape)} {bad.dtype} table "
                             f"at {bad.data_ptr() % 16} bytes past a 16-byte boundary")
    log(f"[3] row loops of bulk copies: {held} edge cases bit-equal to the plain versions, "
        "a 24-byte row and an unaligned view refused")
    return held


def phase_probes(floor: float):
    """The probe entry point as a user runs it, its launches counted from 0:
    the six gather-probe kernels at every one of its shapes, each against
    its plain version (the probe raises on a disagreement), then the times.
    A kernel's entry sums its shapes; each shape's line also has its
    ``torch.index_select`` time where there is one. Returns (entries,
    launch counts)."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.probes import gather

    build.reset_launch_counts()
    t0 = time.time()
    records = gather.main()
    counts = dict(build.LAUNCHES)
    log(f"[3] probes.gather.main in {time.time() - t0:.1f} s; launches {counts}")
    if set(counts) != set(PROBE_REPLACES) or min(counts.values()) < 1:
        raise AssertionError(f"probe launch counts {counts}: want each of {set(PROBE_REPLACES)}")
    loop_edge_cases()  # after the count: comparisons, not the probe's launches
    out = []
    for name, site in PROBE_REPLACES.items():
        recs = [r for r in records if r["kernel"] == name and "bound_ms" in r]
        if not recs:
            raise AssertionError(f"the probe timed no shape of {name}")
        lib = [r["library_ms"] for r in recs]
        entry = {"name": name, "route": "cuda",
                 "source": "unboundednerfpytorch_tpu_torch/csrc/gather_probe.cu",
                 "replaces": site, "max_abs_err": max(r["max_abs_err"] for r in recs),
                 "ms": sum(r["ms"] for r in recs),
                 "plain_ms": sum(r["plain_ms"] for r in recs),
                 "bound_ms": sum(r["bound_ms"] for r in recs), "bound_by": "bytes",
                 "library_ms": None if None in lib else sum(lib), "floor_ms": floor,
                 "shapes": [dict(shape_line(f"{name} {r['probe']} {r['shape']}", r["ms"],
                                            r["call_ms"], r["bound_ms"], floor),
                                 library_ms=r["library_ms"]) for r in recs]}
        for r in recs:
            if r["library_ms"] is not None:
                log(f"[3] {name} {r['probe']} {r['shape']}: {r['ms']:.4f} ms against "
                    f"torch.index_select's {r['library_ms']:.4f} ms "
                    f"({r['library_ms'] / r['ms']:.2f}x)")
        log(f"[3] {name} over {len(recs)} shapes: {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, library call {entry['library_ms']}, bound "
            f"{entry['bound_ms']:.4f} ms (bytes)")
        out.append(entry)
    return out, counts


def profile_summary(tag: str, prof, n_units: int, unit: str, unit_ms: float, ranges) -> None:
    """Device time over the profiled window, per ``unit`` (a train step or a
    rendered view): its share of the unprofiled unit's wall time (the
    profiler slows the host, not the device), by ``record_function`` range
    and by kernel. The hand-written kernels launch inside ``torch.library``
    ops, so the profiler credits them to the range around them; the train
    step's backward runs on autograd's thread, outside its range, and is what
    remains."""
    from torch.autograd import DeviceType

    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        log(f"{tag} profile: torch.profiler saw no device kernels")
        return
    per_unit = lambda us: us / 1e3 / n_units
    busy = per_unit(sum(e.self_device_time_total for e in kernels))
    log(f"{tag} profile over {n_units} {unit}s: device busy {busy:.2f} ms/{unit}, "
        f"{100 * busy / unit_ms:.1f}% of the {unit_ms:.1f} ms unprofiled {unit}")
    phases = {e.key: per_unit(e.device_time_total) for e in avgs
              if e.device_type == DeviceType.CPU and e.key in ranges}
    phases["outside these ranges"] = busy - sum(phases.values())
    for name, ms in phases.items():
        log(f"  range {name}: {ms:.3f} ms/{unit} ({100 * ms / busy:.1f}% of device time)")
    for name in build.KERNELS:
        ms = per_unit(sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key))
        if ms > 0:
            log(f"  kernel {name}: {ms:.3f} ms/{unit} ({100 * ms / busy:.1f}% of device time)")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:15]:
        log(f"  {per_unit(e.self_device_time_total):9.3f} ms/{unit} "
            f"{e.count / n_units:6.1f}x  {e.key[:110]}")


def make_profiler():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA],
                                  acc_events=True)


def phase_scene(tmp: pathlib.Path, views: int):
    """Write the synthetic scene in the Mip-NeRF-360 layout and load it as the
    command line does. Returns (the config file, the data_dict)."""
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic

    t0 = time.time()
    data = synthetic.orbit_scene(views, H, W, seed=0, cam_radius=CAM_RADIUS,
                                 sphere_radius=SPHERE_RADIUS)
    t1 = time.time()
    scene = synthetic.write_llff_scene(str(tmp / "360_v2_bicycle"), data, factor=8)
    t2 = time.time()
    cfg_file = write_config(tmp / "bicycle_cli.py", CONFIG, scene, tmp / "logs", CLI_STEPS)
    data = common.load_everything(loader.load_config(cfg_file))
    t3 = time.time()
    log(f"[4] scene of {views} views of {H}x{W}: made in {t1 - t0:.2f} s, written as PNG in "
        f"{t2 - t1:.2f} s ({dir_gb(os.path.join(scene, 'images_8')) * 1e3:.1f} MB), loaded by "
        f"load_everything in {t3 - t2:.2f} s ({len(data['i_train'])} training views, test "
        f"views {list(data['i_test'])}; near_clip {data['near_clip']:.4f}, far "
        f"{data['far']:.4f}; sphere radius {sphere_radius_of(data):.4f} in the loaded frame)")
    if list(data["i_test"]) != list(range(0, views, 8)):  # llffhold=8
        raise AssertionError(f"held-out views {list(data['i_test'])}")
    return cfg_file, data


def phase_train(cfg, steps: int, data, profile: bool, exp_dir: str, card: str,
                tv_shapes: dict):
    """Returns the launch counts of the train run. ``tv_shapes`` holds the
    full-width grid shapes the run must end at."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.convert import (
        fourier_grid_params_from_numpy, params_to_numpy,
    )
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    log(f"[4] config {CONFIG.relative_to(ROOT)}: {fm.num_voxels_density} voxels, "
        f"freq {fm.fourier_freq_num}, rgbnet_dim {fm.rgbnet_dim}, width {fm.rgbnet_width}, "
        f"grid {fm.grid_dtype}, N_rand {ft.N_rand}, sample_budget {fm.sample_budget}, "
        f"probe stride {fm.budget_probe_stride}, weights main {ft.weight_main} entropy "
        f"{ft.weight_entropy_last} nearclip {ft.weight_nearclip} distortion "
        f"{ft.weight_distortion} rgbper {ft.weight_rgbper}, tv {ft.weight_tv_density}/"
        f"{ft.weight_tv_k0}, rand_bkgd {cfg.data.rand_bkgd}, pg_scale {ft.pg_scale} (the "
        f"config's own boundaries compressed), decay_after_scale {ft.decay_after_scale}")

    xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid",
                                                            device="cuda")
    seed_fn = synthetic.occupancy_seed((xyz_min + xyz_max) / 2, (xyz_max - xyz_min) / 2,
                                       sphere_radius=sphere_radius_of(data))

    # a fixed evaluation batch, composited on grey (the mean of rand_bkgd's
    # uniform draw): the model at init and after the steps
    store = loop.gather_training_rays(cfg, data, "cpu")
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, store["rgb"].shape[0], 4096))
    ev_rays = [store[k][idx] for k in ("rays_o", "rays_d", "viewdirs", "rgb")]
    del store

    def eval_psnr(params, mcfg, device):
        ro, rd, vd, rgb = (t.to(device) for t in ev_rays)
        with torch.no_grad():
            out = fg.forward(params, mcfg, ro, rd, vd, bg=0.5)
        return out, float(-10.0 * torch.log10(torch.mean((out.rgb_marched - rgb) ** 2)))

    psnrs, stamps, peaks, lr_scales, boundaries = [], [], [], [], {}
    first_profiled = steps - PROFILED_STEPS + 1 if profile else steps + 1
    # made only when asked for: an unused profiler object crashes the
    # interpreter at exit ("Requested callback is not found", torch 2.11)
    prof = make_profiler() if profile else None

    def callback(step, metrics):
        loss = float(metrics["loss"])  # synchronises the step
        stamps.append(time.perf_counter())
        psnrs.append(float(metrics["psnr"]))
        lr_scales.append(float(metrics["lr_scale"]))
        if "pg_scale" in metrics:
            boundaries[step] = metrics["pg_scale"]
        # the peak of this step alone (a boundary's work counts to its step)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        if not np.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
        if prof is not None and step == first_profiled - 1:
            prof.start()
        elif prof is not None and step == steps:
            prof.stop()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_start = time.perf_counter()
    _, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cuda", log_fn=log, log_every=5,
                                        callback=callback, coarse_mask_fn=seed_fn)
    counts = dict(build.LAUNCHES)
    # what phase 5 renders: the parameters without the optimizer's state (the
    # loop's own save with it is phase 6a's; see the note at CLI_SAVE_EVERY)
    ckpt.save_model(os.path.join(exp_dir, "fine_last"), "FourierGrid", mcfg, params,
                    global_step=steps)
    dts = np.diff([t_start] + stamps) * 1e3  # dts[i] is step i + 1
    log(f"[4] grids density {tuple(params.density.grid.shape)} k0 "
        f"{tuple(params.k0.grid.shape)} {params.k0.grid.dtype}; S={2 * mcfg.n_inner} -> "
        f"budget {mcfg.sample_budget}; act_shift {params.act_shift:.4f}")

    # ---- the schedule: what each boundary did, and what must hold around it
    nv = (fm.num_voxels_density, fm.num_voxels_rgb)
    if sorted(boundaries) != list(PG_SCALE):
        raise AssertionError(f"boundaries crossed at {sorted(boundaries)}, want {PG_SCALE}")
    for i, b in enumerate(PG_SCALE):
        rec, div = boundaries[b], 2 ** (len(PG_SCALE) - 1 - i)
        want_cfg = mcfg.with_num_voxels(int(nv[0] / div), int(nv[1] / div))
        sec = rec["seconds"]
        log(f"[4] boundary at step {b} on {card}: grids -> {rec['world_size_density']}, "
            f"occupancy {rec['occupancy_carried']:.4f} (the old mask on the new lattice) -> "
            f"{rec['occupancy']:.4f}, sample_budget {rec['sample_budget']}, seconds resize "
            f"{sec['resize']:.3f} refresh {sec['refresh']:.3f} rebuild {sec['rebuild']:.3f}, the "
            f"whole step {dts[b - 1]:.1f} ms, its peak memory {peaks[b - 1]:.2f} GB")
        if (rec["world_size_density"], rec["world_size_rgb"]) != (
                want_cfg.world_size_density, want_cfg.world_size_rgb):
            raise AssertionError(f"boundary {b}: grids {rec['world_size_density']} / "
                                 f"{rec['world_size_rgb']}, want {want_cfg.world_size_density}")
        # with a seed mask the budget is on from the first step, and the
        # occupancy under 1; the refresh may only take voxels away from what
        # the old mask holds on the new lattice (a share that resampling the
        # seed moves by a percent or two from that on the old lattice)
        if not rec["sample_budget_before"] == rec["sample_budget"] == fm.sample_budget:
            raise AssertionError(f"boundary {b}: sample_budget {rec['sample_budget_before']} "
                                 f"-> {rec['sample_budget']}")
        if not 0.0 < rec["occupancy"] <= rec["occupancy_carried"] < 1.0:
            raise AssertionError(f"boundary {b}: occupancy {rec['occupancy_carried']} -> "
                                 f"{rec['occupancy']}")
    last_occupancy = boundaries[PG_SCALE[-1]]["occupancy"]
    if mcfg.num_voxels_density != nv[0] or mcfg.sample_budget != fm.sample_budget:
        raise AssertionError(f"final config: {mcfg.num_voxels_density} voxels, budget "
                             f"{mcfg.sample_budget}")
    if tuple(params.k0.grid.shape) != tv_shapes["k0"] or params.k0.grid.dtype != torch.bfloat16:
        raise AssertionError(f"final k0 grid {tuple(params.k0.grid.shape)} "
                             f"{params.k0.grid.dtype}, want {tv_shapes['k0']} bf16")
    if tuple(params.density.grid.shape) != tv_shapes["density"]:
        raise AssertionError(f"final density grid {tuple(params.density.grid.shape)}")
    if abs(float(params.mask_cache.mask.float().mean()) - last_occupancy) > 1e-6:
        raise AssertionError("the final mask is not the last boundary's")
    want_shift = mcfg.act_shift - len(PG_SCALE) * ft.decay_after_scale
    if abs(params.act_shift - want_shift) > 1e-6:
        raise AssertionError(f"act_shift {params.act_shift}, want {want_shift}")
    # the lr is at its base at step 1 and at every boundary, and under it between
    at_base = [i + 1 for i, x in enumerate(lr_scales) if x == 1.0]
    if at_base != [1, *PG_SCALE] or max(lr_scales) > 1.0:
        raise AssertionError(f"lr_scale is 1 at steps {at_base}, want {[1, *PG_SCALE]}")

    def median_ms(first, last):  # steps first..last, unprofiled ones only
        picked = dts[first - 1:min(last, first_profiled - 1)]
        if len(picked) == 0:
            raise AssertionError(f"no unprofiled step between {first} and {last} to time")
        return float(np.median(picked)), len(picked)

    before_ms, n_before = median_ms(PG_SCALE[-2] + 1, PG_SCALE[-1] - 1)
    step_ms, n_after = median_ms(PG_SCALE[-1] + 1 + WARMUP_STEPS, steps)
    peak_gb = max(peaks)
    log(f"[4] {steps} steps on {card}: train psnr first {psnrs[0]:.4f} last {psnrs[-1]:.4f}; "
        f"ms/step before the last boundary (grids {boundaries[PG_SCALE[-2]]['world_size_density']}"
        f", median of {n_before}) {before_ms:.1f}; after it, at full width (median of {n_after} "
        f"after {WARMUP_STEPS} warm-up steps) {step_ms:.1f}; first step {dts[0]:.1f}; peak "
        f"memory {peak_gb:.2f} GB (step {int(np.argmax(peaks)) + 1}; a full-width step "
        f"{peaks[-1]:.2f} GB); launches {counts}")
    want = {"tv_add_grad": 2 * steps, "march_forward": steps, "march_backward": steps,
            "masked_adam": adam_wanted("[4]", steps)}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if profile:
        profile_summary("[4]", prof, PROFILED_STEPS, "step", step_ms,
                        ("train_loop/batch", "train_step/forward_loss", "train_step/tv",
                         "train_step/adam"))

    init = fg.create(mcfg, torch.Generator().manual_seed(0), device="cuda")
    init.mask_cache.mask = params.mask_cache.mask
    _, psnr_init = eval_psnr(init, mcfg, "cuda")
    del init
    _, psnr_trained = eval_psnr(params, mcfg, "cuda")
    log(f"[4] eval psnr (4096 fixed rays, grey background): init {psnr_init:.5f} -> "
        f"after {steps} steps {psnr_trained:.5f}")
    if not psnr_trained > psnr_init:
        raise AssertionError("eval psnr did not rise")

    # the trained model on the card against the plain path on the CPU. Both
    # take an all-true occupancy cache: the nearest-voxel lookup may round a
    # point differently on the two devices, which would select other samples
    cpu_params = fourier_grid_params_from_numpy(params_to_numpy(params), "cpu")
    for name in ("density", "k0"):
        grid = getattr(cpu_params, name).grid
        grid.data = grid.data.to(getattr(params, name).grid.dtype)
    cpu_params.mask_cache.mask = torch.ones_like(cpu_params.mask_cache.mask)
    params.mask_cache.mask = torch.ones_like(params.mask_cache.mask)
    out_gpu, _ = eval_psnr(params, mcfg, "cuda")
    out_cpu, _ = eval_psnr(cpu_params, mcfg, "cpu")
    for field in ("rgb_marched", "alphainv_last", "weights"):
        got, ref = getattr(out_gpu, field), getattr(out_cpu, field)
        if got.shape != ref.shape:
            raise AssertionError(f"{field}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        check(f"trained forward {field} (card vs CPU plain path)", got.cpu(), ref, 1e-4, 1e-5)
    return counts


def phase_boundary(cfg, card: str) -> None:
    """One pg_scale boundary on the card against the same boundary on the CPU
    from one state: ``PG_SCALE``'s first, from 200^3 / 4 voxels to 200^3 / 2.

    The state stands for a model some thousand steps into its stage, which a
    few smoke steps cannot make: free space trained empty (raw density -5, an
    alpha under the threshold), the synthetic scene's ball and haze imprinted,
    seeded noise on every bank of both grids, the analytic seed as the
    occupancy cache, Adam's moments and step count non-zero, and the sample
    budget still deferred. Checked on the card: the refresh takes the mask
    strictly under the share it carried over, and no voxel appears that the
    old mask, looked up at the new lattice, did not hold; the deferred budget
    comes on; Adam starts over on the new parameters. Card against CPU: the
    new grids (bf16, each the rounding of an f32 lerp) equal but for elements
    whose f32 value rounds the other way, at most 1e-3 of them and each by
    one bf16 step; the new masks equal but for voxels whose pooled alpha lies
    within one grain of float32 alpha (2^-24) of ``fast_color_thres``. The
    flips are counted, not absorbed."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.convert import (
        fourier_grid_params_from_numpy, params_to_numpy,
    )
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.fields.grids import MaskGrid
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.train.step import create_train_state

    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    div = 2 ** len(PG_SCALE)
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    mcfg = fg.config_from(fm, lo, hi, int(fm.num_voxels_density / div),
                          int(fm.num_voxels_rgb / div))
    mcfg = dataclasses.replace(mcfg, sample_budget=0)  # deferred: no refresh yet
    params = fg.create(mcfg, torch.Generator().manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        dgrid = params.density.grid
        dgrid += (0.3 * torch.randn(dgrid.shape, generator=gen, device="cuda")).to(dgrid.dtype)
        dgrid[0] += -5.0 * dgrid.shape[0]
    synthetic.imprint_scene(params, mcfg.scene_center, mcfg.scene_radius, seed=0)
    seed_fn = synthetic.occupancy_seed(np.zeros(3), np.ones(3))
    params.mask_cache.mask = torch.as_tensor(
        seed_fn(params.mask_cache.mask.shape, mcfg.xyz_min, mcfg.xyz_max), device="cuda")
    cpu_params = fourier_grid_params_from_numpy(params_to_numpy(params), "cpu")
    for name in ("density", "k0"):
        grid = getattr(cpu_params, name).grid
        grid.data = grid.data.to(getattr(params, name).grid.dtype)

    states = []
    for p_ in (params, cpu_params):
        state = create_train_state(p_, ft)
        state.optimizer.step_count = 7
        for m in (*state.optimizer.exp_avg.values(), *state.optimizer.exp_avg_sq.values()):
            m.fill_(0.5)
        states.append(state)
    old_mask = MaskGrid(params.mask_cache.mask.shape, mcfg.xyz_min, mcfg.xyz_max,
                           mask=params.mask_cache.mask.clone())
    old_shift = params.act_shift
    step = PG_SCALE[0]

    build.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = {}
    state, new_cfg, rec = loop.pg_scale_boundary(states[0], mcfg, fm, ft, step,
                                                 deferred_budget=fm.sample_budget, report=report)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    cpu_state, cpu_cfg, cpu_rec = loop.pg_scale_boundary(states[1], mcfg, fm, ft, step,
                                                         deferred_budget=fm.sample_budget)
    cpu_s = time.perf_counter() - t0
    sec = rec["seconds"]
    log(f"[4b] boundary {mcfg.world_size_density} -> {rec['world_size_density']} on {card}: "
        f"{card_s:.3f} s (resize {sec['resize']:.3f}, refresh {sec['refresh']:.3f}, rebuild "
        f"{sec['rebuild']:.3f}), peak memory {peak_gb:.2f} GB; on the CPU {cpu_s:.1f} s; "
        f"occupancy {float(old_mask.mask.float().mean()):.4f} -> {rec['occupancy']:.4f} "
        f"(CPU {cpu_rec['occupancy']:.4f})")
    if build.LAUNCHES:
        raise AssertionError(f"a boundary launched {dict(build.LAUNCHES)}")

    # ---- what the boundary must do, on the card
    if new_cfg != cpu_cfg or new_cfg.sample_budget != fm.sample_budget or (
            rec["sample_budget_before"], rec["sample_budget"]) != (0, fm.sample_budget):
        raise AssertionError(f"config after the boundary: budget {new_cfg.sample_budget}")
    want_ws = mcfg.with_num_voxels(new_cfg.num_voxels_density, new_cfg.num_voxels_rgb)
    if (tuple(params.density.grid.shape[1:4]), tuple(params.k0.grid.shape[1:4])) != (
            want_ws.world_size_density, want_ws.world_size_rgb):
        raise AssertionError(f"grids {tuple(params.k0.grid.shape)} after the boundary")
    if abs(params.act_shift - (old_shift - ft.decay_after_scale)) > 1e-9:
        raise AssertionError(f"act_shift {params.act_shift}")
    opt = state.optimizer
    held = set(opt.exp_avg) == set(opt.exp_avg_sq) == {
        q for q in params.parameters() if q.requires_grad}
    fresh = all(float(m.abs().max()) == 0.0 and m.shape == q.shape
                for moments in (opt.exp_avg, opt.exp_avg_sq) for q, m in moments.items())
    if not (held and fresh and opt.step_count == 0 and state.step == step - 1):
        raise AssertionError("Adam did not start over on the new parameters")
    ws = rec["world_size_density"]
    axes = [torch.linspace(a, b, n, device="cuda")
            for a, b, n in zip(mcfg.xyz_min, mcfg.xyz_max, ws)]
    carried = old_mask(torch.stack(torch.meshgrid(*axes, indexing="ij"), -1))
    mask = params.mask_cache.mask
    if bool((mask & ~carried).any()) or not rec["occupancy"] < float(carried.float().mean()):
        raise AssertionError("the refresh added voxels, or took none away")

    # ---- card against CPU
    for name in ("density", "k0"):
        got = getattr(params, name).grid.detach().float().cpu()
        ref = getattr(cpu_params, name).grid.detach().float()
        diff = (got - ref).abs()
        n_diff = int((diff > 0).sum())
        step_of = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
        worst = float((diff / step_of).max())
        log(f"  boundary {name} grid {tuple(got.shape)}: {n_diff} of {got.numel()} elements "
            f"differ between card and CPU, the worst by {worst:.2f} bf16 steps")
        if n_diff > 1e-3 * got.numel() or worst > 1.0:
            raise AssertionError(f"boundary {name} grid: card and CPU disagree")
    pooled = report["pooled_alpha"]  # what the refresh on the card held against the threshold
    # float32 alpha is 1 - exp(..), a multiple of 2^-24 (the grain), and the
    # two devices' exp may round a value to neighbouring grains: a voxel whose
    # pooled alpha lies within one grain of the threshold may get another
    # verdict. Those voxels are counted, and no other may differ
    grain = 2.0 ** -24
    off = (pooled - new_cfg.fast_color_thres).abs().cpu()
    flipped = mask.cpu() != cpu_params.mask_cache.mask
    n_flipped, n_near = int(flipped.sum()), int((off <= grain).sum())
    log(f"  boundary mask {tuple(mask.shape)}: {n_flipped} of {flipped.numel()} voxels differ "
        f"between card and CPU; {n_near} voxels have a pooled alpha within one grain (2^-24) "
        f"of the threshold {new_cfg.fast_color_thres:g}")
    if n_flipped and float(off[flipped].max()) > grain:
        raise AssertionError(f"a voxel whose pooled alpha is {float(off[flipped].max())} off "
                             "the threshold differs between card and CPU")


def phase_render(cfg, data, exp_dir: str, cfg_file: str, profile: bool,
                 style: pathlib.Path) -> dict:
    """Phase 5, and 11g: the command line's render runs with ``--style_root``
    over the seeded style image ``style``, whose colour statistics the
    stylized views must take (``check_arf``). Returns the launch counts of
    the command line's render."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch import render
    from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
    from unboundednerfpytorch_tpu_torch.convert import (
        fourier_grid_params_from_numpy, params_to_numpy,
    )
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import metrics as M

    path = f"{exp_dir}/fine_last"
    t0 = time.time()
    family, mcfg, params, step, _ = ckpt.load_model(path, device="cuda", with_opt_state=False)
    params.requires_grad_(False)
    synthetic.imprint_scene(params, mcfg.scene_center, mcfg.scene_radius, seed=0,
                            sphere_radius=sphere_radius_of(data))
    final_thres = normalize_fast_color_thres(cfg.fine_model_and_render)[1][-1][1]
    mcfg = dataclasses.replace(mcfg, fast_color_thres=final_thres)
    ckpt.save_model(path, family, mcfg, params, global_step=step)
    log(f"[5] checkpoint of step {step} loaded, scene imprinted, fast_color_thres "
        f"{final_thres:g}, saved again in {time.time() - t0:.1f} s")

    # ---- the command line's render program, as a user runs it
    n_views = len(data["i_test"])
    n_chunks = -(-H * W // RENDER_CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.time()
    with Spy(render, "run_render") as spy, Spy(render, "render_viewpoints") as views:
        run_cli(["--config", cfg_file, "--program", "render", "--render_test", "--ft_path",
                 path, "--style_root", str(style.parent), "--style_id", style.stem])
    total_s = time.time() - t0
    out = spy.calls[0].result["test"]
    counts = dict(build.LAUNCHES)
    check_arf("[11g]", out["rgbs"], views.calls[0].result["rgbs"], style)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"march_forward": n_views * n_chunks}
    if counts != want:
        raise AssertionError(f"render launch counts {counts} != {want}")
    for name in ("rgbs", "depths", "bgmaps"):
        arr = out[name]
        if arr.shape[:3] != (n_views, H, W) or not np.isfinite(arr).all():
            raise AssertionError(f"rendered {name}: shape {arr.shape} or non-finite values")
    view_ms = float(np.median(out["seconds"][1:])) * 1e3
    SHARED["5"] = {"view_ms": view_ms}
    log(f"[5] --program render: {n_views} views of {H}x{W} in {n_chunks} chunks of "
        f"{RENDER_CHUNK}, {total_s:.1f} s with the scene's load, the checkpoint's and the "
        f"cache build (run_render {spy.calls[0].seconds:.1f} s); ms/view "
        f"{[round(t * 1e3, 1) for t in out['seconds']]}, median after the warm-up view "
        f"{view_ms:.1f} ms = {H * W / view_ms * 1e3:.0f} rays/s; peak memory {peak_gb:.2f} GB; "
        f"psnr {np.mean(out['psnrs']):.3f} ssim {np.mean(out['ssims']):.4f} against ground "
        f"truth; launches {counts}")

    # ---- the cached forwards against each other, view by view over the test
    # views until 1000 rays that end on the ball stay within color_budget (a
    # ray that enters the scene box through the imprinted haze overflows it)
    def view_rays(idx):
        ro, rd, vd = ray_ops.get_rays_of_a_view(
            H, W, torch.as_tensor(data["Ks"][idx], device="cuda"),
            torch.as_tensor(data["poses"][idx][:3, :4], device="cuda"),
            inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
        return [x.reshape(-1, 3) for x in (ro, rd, vd)]

    render_kwargs = {"bg": 1.0, "stepsize": cfg.fine_model_and_render.stepsize}
    fwd = loop.make_forward(mcfg, render_kwargs)
    baked = fg.build_render_cache(params, mcfg, log_fn=lambda m: log(f"[5] {m}"))
    exact = fg.build_render_cache(params, dataclasses.replace(mcfg, density_bake_scale=0.0),
                                  log_fn=lambda m: log(f"[5] {m}"))
    if baked.density_dims is None or exact.density_dims is not None:
        raise AssertionError(f"cache branches: {baked.branch} / {exact.branch}")
    cb = mcfg.color_budget
    rgb = {"baked": [], "exact": [], "single": []}
    over_ray, over_chunk, hit, views = [], [], [], []
    with torch.no_grad():
        for idx in np.asarray(data["i_test"]).tolist():
            views.append(idx)
            n0 = len(hit)
            ro, rd, vd = view_rays(idx)
            for a in range(0, H * W, RENDER_CHUNK):
                sl = slice(a, a + RENDER_CHUNK)
                r_exact = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=exact)
                r_baked = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=baked)
                r_single = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=None)
                if not (r_exact.rgb_compacted and r_baked.rgb_compacted) or \
                        r_single.rgb_compacted:
                    raise AssertionError("a forward took another branch than asked for")
                rgb["exact"].append(r_exact.rgb_marched)
                rgb["baked"].append(r_baked.rgb_marched)
                rgb["single"].append(r_single.rgb_marched)
                over_ray.append(r_exact.mask.sum(-1) > cb)
                over_chunk.append((float(r_exact.color_overflow_frac),
                                   float(r_baked.color_overflow_frac)))
                hit.append(r_exact.alphainv_last < 0.01)
            n_hit_keep = int((torch.cat(hit) & ~torch.cat(over_ray)).sum())
            log(f"[5] view {idx}: {int(torch.cat(hit[n0:]).sum())} rays end on the ball; "
                f"of the views so far, {n_hit_keep} such rays within color_budget")
            if n_hit_keep >= 1000:
                break
    rgb = {k: torch.cat(v) for k, v in rgb.items()}
    over_ray, hit = torch.cat(over_ray), torch.cat(hit)
    keep = ~over_ray
    log(f"[5] views {views}: {int(hit.sum())} of {len(views) * H * W} rays end on the ball; "
        f"color_overflow_frac (share of rays with more than {cb} survivors) exact "
        f"{np.mean([c[0] for c in over_chunk]):.4f} baked "
        f"{np.mean([c[1] for c in over_chunk]):.4f}; chunks with any overflow "
        f"{sum(c[0] > 0 for c in over_chunk)} of {len(over_chunk)}")
    if float(keep.float().mean()) < 0.1 or int((keep & hit).sum()) < 1000:
        raise AssertionError("too few rays without overflow to compare the two stages")
    check(f"two-stage exact cache vs uncached single stage, {int(keep.sum())} rays without "
          "overflow", rgb["exact"][keep], rgb["single"][keep], 1e-4, 1e-6)
    psnr_baked = M.psnr(rgb["baked"].cpu().numpy(), rgb["exact"].cpu().numpy())
    log(f"[5] baked density ({baked.branch}) against the exact two-stage render, views {views}: "
        f"psnr {psnr_baked:.2f} dB (floor {BAKED_MIN_PSNR})")
    if not psnr_baked > BAKED_MIN_PSNR:
        raise AssertionError(f"baked render psnr {psnr_baked} <= {BAKED_MIN_PSNR}")
    idx = views[0]
    ro, rd, vd = view_rays(idx)
    del exact, rgb

    # ---- the main path's forward on the card against the same path on the CPU
    t0 = time.time()
    mid = (n_chunks // 2) * RENDER_CHUNK + RENDER_CHUNK // 4  # rows through the ball
    sl = slice(mid, mid + RENDER_CHUNK)
    cpu_params = fourier_grid_params_from_numpy(params_to_numpy(params), "cpu")
    for name in ("density", "k0"):
        grid = getattr(cpu_params, name).grid
        grid.data = grid.data.to(getattr(params, name).grid.dtype)
    cpu_params.requires_grad_(False)
    cpu_cache = dataclasses.replace(
        baked, density_tables=tuple(t.cpu() for t in baked.density_tables),
        k0_tables=tuple(t.cpu() for t in baked.k0_tables))
    fields = ("rgb_marched", "depth", "alphainv_last")
    with torch.no_grad():
        got = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=baked)
        ref = fwd(cpu_params, ro[sl].cpu(), rd[sl].cpu(), vd[sl].cpu(), None, cache=cpu_cache)
        # the scene's occupancy: a sample on a voxel's half-way point may round
        # to another voxel on the other device, which selects other samples
        same = torch.ones(RENDER_CHUNK, dtype=torch.bool)
        for f in fields:
            g, r = getattr(got, f).cpu(), getattr(ref, f)
            d = (g - r).abs()
            same &= (d.reshape(RENDER_CHUNK, -1).amax(-1) <= 1e-5 + 1e-4 * float(r.abs().max()))
        log(f"[5] card vs CPU, one chunk, the scene's occupancy: {int(same.sum())} of "
            f"{RENDER_CHUNK} rays agree; {int((got.alphainv_last < 0.01).sum())} end on the ball")
        if float(same.float().mean()) < 0.995:
            raise AssertionError("the card's render and the CPU's differ on more than 0.5% "
                                 "of the rays")
        for p_ in (params, cpu_params):
            p_.mask_cache.mask = torch.ones_like(p_.mask_cache.mask)
        got = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=baked)
        ref = fwd(cpu_params, ro[sl].cpu(), rd[sl].cpu(), vd[sl].cpu(), None, cache=cpu_cache)
        # a sample whose alpha or weight lies within rounding of
        # fast_color_thres passes on one device only, and moves its ray by
        # about that threshold. Such samples are counted by comparing the two
        # masks (2 of 786,432 on an H100; the trained grids differ in their
        # last bits from run to run, the backward's adds being atomic, so a
        # few more are allowed for: 1e-5 of the samples), and only their rays
        # get the looser tolerance
        flipped = got.mask.cpu() != ref.mask
        n_flipped = int(flipped.sum())
        log(f"[5] all-true occupancy: {n_flipped} of {flipped.numel()} samples pass "
            f"fast_color_thres {mcfg.fast_color_thres:g} on one device only, on "
            f"{int(flipped.any(-1).sum())} rays")
        if n_flipped > MAX_FLIPPED_SHARE * flipped.numel():
            raise AssertionError(f"{n_flipped} samples differ in the threshold mask")
        same = ~flipped.any(-1)
        for f in fields + ("weights",):
            g, r = getattr(got, f).cpu(), getattr(ref, f)
            check(f"cached render {f}, all-true occupancy, rays of equal masks (card vs CPU)",
                  g[same], r[same], 1e-5, 1e-5)
            if n_flipped:
                check(f"cached render {f}, rays of a flipped sample", g[~same], r[~same],
                      1e-4, 2 * mcfg.fast_color_thres)
    log(f"[5] card-vs-CPU comparison took {time.time() - t0:.1f} s")
    del cpu_params, cpu_cache

    if profile:
        _, _, params, _, _ = ckpt.load_model(path, device="cuda")  # the occupancy again
        params.requires_grad_(False)
        view = lambda: renderer.render_image(
            lambda aux, o, d, v: fwd(aux[0], o, d, v, None, cache=aux[1]), H, W,
            data["Ks"][idx], data["poses"][idx][:3, :4], chunk=RENDER_CHUNK,
            aux=(params, baked), inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y)
        view()
        prof = make_profiler()
        prof.start()
        for _ in range(2):
            view()
        prof.stop()
        profile_summary("[5]", prof, 2, "view", view_ms,
                        ("render/rays", "forward/sample", "forward/density", "forward/march",
                         "forward/compact", "forward/k0", "forward/rgb"))
    return counts


def train_counts_of(total: dict, render_counts: dict) -> dict:
    out = {k: v - render_counts.get(k, 0) for k, v in total.items()}
    return {k: v for k, v in out.items() if v}


def check_cli_run(tag: str, total: dict, render, steps: int, n_views: int,
                  hw: tuple, per_step=TRAIN_PER_STEP, per_chunk=("march_forward",)) -> list:
    """The launches of a command-line ``train`` (the steps, then the render
    of the test views that follows; ``render`` is the render's call, as
    ``render_spy`` or ``cli_train_in_memory`` records it): ``per_step`` a
    step (``tv_add_grad`` 2, both march kernels 1; DCVGO adds
    ``cumdist_thres``), ``masked_adam`` as often as the optimizer should have
    launched it, each kernel of ``per_chunk`` once per render chunk, and
    nothing else. Returns [train counts, render counts]."""
    import numpy as np

    out = render.result["test"]
    if out["rgbs"].shape[:3] != (n_views, *hw) or not np.isfinite(out["rgbs"]).all():
        raise AssertionError(f"{tag}: rendered {out['rgbs'].shape} or non-finite values")
    train = train_counts_of(total, render.launches)
    want = {k: v * steps for k, v in per_step.items()}
    want["masked_adam"] = adam_wanted(tag, steps)
    want_render = {k: n_views * -(-hw[0] * hw[1] // RENDER_CHUNK) for k in per_chunk}
    if train != want or render.launches != want_render:
        raise AssertionError(f"{tag}: launches train {train} (want {want}), render "
                             f"{render.launches} (want {want_render})")
    log(f"{tag} launches: train {train}, render {render.launches}; render "
        f"{[round(t * 1e3, 1) for t in out['seconds']]} ms/view, psnr "
        f"{np.mean(out['psnrs']):.3f}")
    return [train, render.launches]


def render_spy():
    """A spy on ``render.run_render`` that keeps the launches of each call
    and the peak memory before it (the training's, where training ran)."""
    import torch

    from unboundednerfpytorch_tpu_torch import render
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    held = {}

    def before(args, kwargs):
        held["launches"] = dict(build.LAUNCHES)
        held["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    def after(call):
        call.launches = launches_since(held["launches"])
        call.peak_before_gb = held["peak_gb"]

    return Spy(render, "run_render", before, after)


class Records:
    """A ``run_train`` callback that keeps what the loop writes to
    ``fine_metrics.jsonl`` where it has an ``exp_dir`` (the record of each
    boundary, then each step's scalars and the seconds since the run
    began), for a run without one."""

    def __init__(self):
        self.records, self.t0 = [], time.time()

    def __call__(self, step, metrics):
        if "pg_scale" in metrics:
            self.records.append({"step": step, "pg_scale": metrics["pg_scale"]})
        self.records.append({"step": step, "elapsed_s": time.time() - self.t0,
                             **{k: v.item() if hasattr(v, "item") else v
                                for k, v in metrics.items() if k != "pg_scale"}})


def render_held_out(tag: str, cfg, data, family: str, mcfg, params) -> dict:
    """The test views rendered from parameters in memory as ``run_render``
    renders a checkpoint's: the family's render cache, its forward, the
    command line's chunk, the ground truth where a view has an image."""
    import numpy as np

    from unboundednerfpytorch_tpu_torch import render
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.train import loop

    params.requires_grad_(False)
    cache = loop.FAMILIES[family].build_render_cache(params, mcfg,
                                                     log_fn=lambda m: log(f"{tag} {m}"))
    fwd_core = loop.make_forward(mcfg, {"near": float(data["near"]), "far": float(data["far"]),
                                        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
                                        "stepsize": cfg.fine_model_and_render.stepsize})
    idx = np.asarray(data["i_test"])
    return renderer.render_viewpoints(
        lambda aux, ro, rd, vd: fwd_core(aux[0], ro, rd, vd, None, cache=aux[1]),
        poses=np.asarray(data["poses"])[idx], HW=np.asarray(data["HW"])[idx],
        Ks=np.asarray(data["Ks"])[idx], gt_imgs=render._ground_truth(data.get("images"), idx),
        ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
        flip_y=cfg.data.flip_y, chunk=RENDER_CHUNK, aux=(params, cache),
        log_fn=lambda m: log(f"{tag} {m}"), device="cuda")


def cli_train_in_memory(tag: str, cfg_file: str, argv=(), load_after=None):
    """A command-line ``train`` that writes no checkpoint: the command line
    itself runs ``--program export_bbox`` with ``argv`` (the config, the data
    through ``load_everything`` with the command line's arguments, which a
    spy keeps, ``args.txt``); that data goes through ``run_train`` with the
    command line's seed and no ``exp_dir``, its records kept by
    ``Records``; then the test views are rendered from the trained
    parameters (``render_held_out``). The save code is held by phases 6a
    and 13a. Returns (the loader's call, the records, (family, config,
    params), the render's call as ``render_spy`` records it)."""
    import argparse as ap

    import torch

    from unboundednerfpytorch_tpu_torch.cli import main as cli
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop

    with Spy(common, "load_everything", after=load_after) as loads:
        run_cli(["--config", cfg_file, "--program", "export_bbox", *argv])
    cfg = loader.load_config(cfg_file)
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    args_txt = open(os.path.join(exp_dir, "args.txt")).read()
    if "program = export_bbox" not in args_txt or not os.path.exists(
            os.path.join(exp_dir, "cam.npz")):
        raise AssertionError(f"{tag}: the command line wrote no args.txt or cam.npz")
    seed = cli.build_parser().get_default("seed")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    records = Records()
    family, mcfg, params, _ = loop.run_train(cfg, loads.calls[0].result, seed=seed,
                                             device="cuda", log_fn=log, log_every=1,
                                             callback=records)
    peak = torch.cuda.max_memory_allocated() / 1e9
    before = dict(build.LAUNCHES)
    out = render_held_out(tag, cfg, loads.calls[0].result, family, mcfg, params)
    call = ap.Namespace(result={"test": out}, launches=launches_since(before),
                        peak_before_gb=peak)
    return loads.calls[0], records.records, (family, mcfg, params), call


def phase_cli_360(cfg_file: str, card: str, n_test: int) -> list:
    """Phase 6a: bicycle_single through the command line, saved and resumed.
    Returns the launch counts of its runs."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.optim import factory
    from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    cfg = loader.load_config(cfg_file)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    full = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    saved = {}

    def on_save(call):
        step, opt = call.kwargs["global_step"], call.kwargs.get("opt_state")
        params = call.args[3]
        call.gb = dir_gb(call.args[0])
        call.world_size = tuple(params.k0.grid.shape[1:4])
        call.occupancy = float(params.mask_cache.mask.float().mean())
        if step == CLI_STEPS and opt is not None:  # what run 2 must restore
            saved["step"] = opt["step"]
            saved["moments"] = {k: {n: [m.clone() for m in ms] for n, ms in opt[k].items()}
                                for k in ("exp_avg", "exp_avg_sq")}

    # ---- run 1: CLI_STEPS steps, unseeded, a periodic save at CLI_SAVE_EVERY
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with Spy(ckpt, "save_model", after=on_save) as saves, render_spy() as renders:
        run_cli(["--config", cfg_file, "--i_weights", str(CLI_SAVE_EVERY), "--i_print", "1"])
    counts = check_cli_run("[6a] run 1", dict(build.LAUNCHES), renders.calls[-1], CLI_STEPS, n_test,
                           (H, W))
    records = read_records(exp_dir)
    bounds = {r["step"]: r["pg_scale"] for r in records if "pg_scale" in r}
    steps = [r for r in records if "loss" in r]
    if sorted(bounds) != list(CLI_PG_SCALE) or [r["step"] for r in steps] != [1, 2, 3, 4]:
        raise AssertionError(f"run 1 records: boundaries {sorted(bounds)}, steps "
                             f"{[r['step'] for r in steps]}")
    if not all(np.isfinite(r["loss"]) for r in steps):
        raise AssertionError("run 1: a loss is not finite")
    first, last = (bounds[b] for b in CLI_PG_SCALE)
    # the loop holds the budget at 0 on an all-true cache (no seed) until the
    # first boundary has refreshed it from trained density, and switches it on
    if (first["sample_budget_before"], first["sample_budget"]) != (0, fm.sample_budget):
        raise AssertionError(f"the deferred budget: {first['sample_budget_before']} -> "
                             f"{first['sample_budget']} at step {CLI_PG_SCALE[0]}")
    if first["occupancy_carried"] != 1.0 or not 0.0 < first["occupancy"] <= 1.0:
        raise AssertionError(f"occupancy {first['occupancy_carried']} -> {first['occupancy']}")
    if tuple(last["world_size_density"]) != full.world_size_density or \
            last["sample_budget"] != fm.sample_budget:
        raise AssertionError(f"last boundary: grids {last['world_size_density']}")
    got = [(c.kwargs["global_step"], c.kwargs.get("opt_state") is not None) for c in saves.calls]
    if got != [(CLI_SAVE_EVERY, True), (CLI_STEPS, True)]:
        raise AssertionError(f"saves (step, with optimizer state): {got}")
    meta = json.load(open(os.path.join(exp_dir, "fine_last", "meta.json")))
    mk = meta["model_kwargs"]
    if (meta["global_step"], meta["has_opt_state"], mk["sample_budget"],
            mk["num_voxels_density"]) != (CLI_STEPS, True, fm.sample_budget,
                                          fm.num_voxels_density):
        raise AssertionError(f"fine_last: {meta['global_step']} {meta['has_opt_state']} "
                             f"{mk['sample_budget']} {mk['num_voxels_density']}")
    if abs(saves.calls[-1].occupancy - last["occupancy"]) > 1e-6:
        raise AssertionError("the saved mask is not the last boundary's")
    dts = np.diff([0.0] + [r["elapsed_s"] for r in steps]) * 1e3
    periodic = saves.calls[0]
    log(f"[6a] run 1 on {card}: budget {first['sample_budget_before']} -> "
        f"{first['sample_budget']} at step {CLI_PG_SCALE[0]} (occupancy "
        f"{first['occupancy_carried']:.4f} -> {first['occupancy']:.4f}), grids "
        f"{last['world_size_density']} from step {CLI_PG_SCALE[1]}; ms/step by the loop's clock "
        f"{[round(float(t), 1) for t in dts]}; peak memory of the training "
        f"{renders.calls[-1].peak_before_gb:.2f} GB; periodic save at step "
        f"{CLI_SAVE_EVERY}: {periodic.gb:.3f} GB in {periodic.seconds:.2f} s (grids "
        f"{periodic.world_size}, with the optimizer's state); final save at full width "
        f"{saves.calls[1].gb:.3f} GB in {saves.calls[1].seconds:.2f} s")

    # ---- run 2: the same command, two steps more: the resume
    write_config(pathlib.Path(cfg_file), CONFIG, cfg.data.datadir, cfg.basedir, CLI_STEPS + 2)
    restored = {}

    def on_restore(call):
        opt = call.args[0]
        restored["step"] = opt.step_count
        restored["equal"] = all(
            torch.equal(a, b) for k in ("exp_avg", "exp_avg_sq")
            for n, ms in opt.state_dict()[k].items() for a, b in zip(ms, saved["moments"][k][n]))

    reset_counts()
    with Spy(ckpt, "load_model") as loads, Spy(MaskedAdam, "load_state_dict",
                                                 after=on_restore), render_spy() as renders:
        lines = run_cli(["--config", cfg_file, "--i_weights", str(CLI_SAVE_EVERY),
                         "--i_print", "1"])
    counts += check_cli_run("[6a] run 2", dict(build.LAUNCHES), renders.calls[-1], 2, n_test,
                            (H, W))
    del saved["moments"]
    said = f"fine: resumed from {exp_dir}/fine_last at step {CLI_STEPS} (with the optimizer's"
    if not any(line.startswith(said) for line in lines):
        raise AssertionError(f"run 2 did not log the resume: {said}")
    if restored != {"step": saved["step"], "equal": True} or saved["step"] < 1:
        raise AssertionError(f"Adam restored {restored}, saved step {saved['step']}")
    records = read_records(exp_dir)[len(records):]
    steps = [r for r in records if "loss" in r]
    if [r["step"] for r in steps] != [CLI_STEPS + 1, CLI_STEPS + 2] or any(
            "pg_scale" in r for r in records):
        raise AssertionError(f"run 2 records {records}")
    anchor = CLI_PG_SCALE[-1]  # the lr decays from the last boundary, as uninterrupted
    want = [factory.lr_decay_scale(float(r["step"] - anchor), ft.lrate_decay) for r in steps]
    if [r["lr_scale"] for r in steps] != want:
        raise AssertionError(f"lr_scale {[r['lr_scale'] for r in steps]}, want {want}")
    load = loads.calls[0]
    if load.result[3] != CLI_STEPS or tuple(load.result[2].k0.grid.shape[1:4]) != \
            full.world_size_rgb:
        raise AssertionError("run 2 loaded another checkpoint")
    log(f"[6a] run 2 on {card}: resumed at step {CLI_STEPS}, Adam step {restored['step']} and "
        f"both moments bit-equal to the saved ones, lr_scale {want} (anchored at step "
        f"{anchor}); full-width load with the optimizer's state {load.seconds:.2f} s "
        f"({dir_gb(os.path.join(exp_dir, 'fine_last')):.3f} GB); ms/step by the loop's clock "
        f"{[round(1e3 * float(r['elapsed_s']), 1) for r in steps]} (from the resume)")
    return counts


def phase_cli_truck(tmp: pathlib.Path, card: str) -> list:
    """Phase 6b: truck_single's command-line train on a NeRF++ scene, without
    its checkpoint (``cli_train_in_memory``: the disk is kept for phase 13a;
    the save code is held by 6a). Returns the launch counts of the run."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    t0 = time.time()
    data = synthetic.orbit_scene(TRUCK_VIEWS, TRUCK_H, TRUCK_W, seed=1, n_test=TRUCK_TEST,
                                 cam_radius=CAM_RADIUS, sphere_radius=SPHERE_RADIUS)
    scene = synthetic.write_nerfpp_scene(str(tmp / "tat_training_Truck"), data)
    cfg_file = write_config(tmp / "truck_cli.py", TRUCK_CONFIG, scene, tmp / "logs", TRUCK_STEPS)
    cfg = loader.load_config(cfg_file)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    full = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    log(f"[6b] config {TRUCK_CONFIG.relative_to(ROOT)}: {2 * fm.fourier_freq_num + 1} banks, "
        f"N_rand {ft.N_rand}, inverse_y {cfg.data.inverse_y}, pg_scale {ft.pg_scale}; scene of "
        f"{TRUCK_VIEWS} + {TRUCK_TEST} views of {TRUCK_H}x{TRUCK_W} made and written in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    load, records, (_, _, params), render = cli_train_in_memory("[6b]", cfg_file,
                                                                ["--i_print", "1"])
    total_s = time.time() - t0
    counts = check_cli_run("[6b]", dict(build.LAUNCHES), render, TRUCK_STEPS, TRUCK_TEST,
                           (TRUCK_H, TRUCK_W))
    bounds = {r["step"]: r["pg_scale"] for r in records if "pg_scale" in r}
    steps = {r["step"]: r for r in records if "loss" in r}
    if sorted(bounds) != list(CLI_PG_SCALE) or sorted(steps) != list(range(1, TRUCK_STEPS + 1)):
        raise AssertionError(f"truck records: boundaries {sorted(bounds)}, steps {sorted(steps)}")
    first = bounds[CLI_PG_SCALE[0]]
    if (first["sample_budget_before"], first["sample_budget"]) != (0, fm.sample_budget):
        raise AssertionError("truck: the deferred budget did not come on at the first boundary")
    want = (2 * fm.fourier_freq_num + 1, *full.world_size_rgb, full.k0_dim)
    if tuple(params.k0.grid.shape) != want or params.k0.grid.dtype != torch.bfloat16:
        raise AssertionError(f"truck k0 grid {tuple(params.k0.grid.shape)}, want {want} bf16")
    ms = [1e3 * (steps[s]["elapsed_s"] - steps[s - 1]["elapsed_s"])
          for s in range(CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS, TRUCK_STEPS + 1)]
    log(f"[6b] truck_single on {card}: load_everything {load.seconds:.2f} s; grids "
        f"{tuple(params.k0.grid.shape)} bf16 from step {CLI_PG_SCALE[-1]}; ms/step at full "
        f"width (steps {CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS} to {TRUCK_STEPS}, the callback's "
        f"clock) {[round(t, 1) for t in ms]}, median {float(np.median(ms)):.1f}; peak memory of "
        f"the training {render.peak_before_gb:.2f} GB, of the whole run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; load, train and render "
        f"{total_s:.1f} s, no checkpoint")
    return counts


# ---------------------------------------------------------------------------
# the DCVGO and DMPIGO families and the host ray store (phases 3 and 7)


def fern_scene(tmp: pathlib.Path):
    """7b's capture, written first because phase 3 holds the kernels at the
    grid it gives: ``FERN_VIEWS`` forward-facing views of ``FERN_H`` x
    ``FERN_W`` in the LLFF layout at factor 4, loaded as the command line
    loads it. Returns (the config file, the scene box in NDC)."""
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod

    t0 = time.time()
    data = synthetic.forward_facing_scene(FERN_VIEWS, FERN_H, FERN_W, seed=4)
    scene = synthetic.write_llff_scene(str(tmp / "nerf_llff_data_fern"), data, factor=4,
                                       bounds=FERN_BOUNDS)
    cfg_file = write_config(tmp / "fern_cli.py", FERN_CONFIG, scene, tmp / "logs", FAMILY_STEPS)
    cfg = loader.load_config(cfg_file)
    data = common.load_everything(cfg)
    box = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "dmpigo", device="cuda")
    log(f"[7b] scene of {FERN_VIEWS} forward-facing views of {FERN_H}x{FERN_W} (LLFF layout, "
        f"images_4) made, written and loaded in {time.time() - t0:.1f} s; test views "
        f"{list(data['i_test'])}; NDC box {box[0].round(4).tolist()} .. "
        f"{box[1].round(4).tolist()}")
    return cfg_file, box


def lego_scene(tmp: pathlib.Path):
    """9a's capture: ``LEGO_TRAIN`` + 2 x ``LEGO_HELD`` views of ``LEGO_H`` x
    ``LEGO_W`` RGBA in the NeRF-synthetic layout, and its config (the stages
    cut to ``LEGO_COARSE_STEPS`` and ``LEGO_FINE_STEPS``, the fine boundaries
    to ``LEGO_PG_SCALE``, a held-out panel at the fine stage's last step:
    phase 11e). Returns the config file."""
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod

    t0 = time.time()
    data = synthetic.orbit_scene(LEGO_TRAIN, LEGO_H, LEGO_W, seed=6, n_test=2 * LEGO_HELD,
                                 cam_radius=LEGO_CAM_RADIUS, sphere_radius=SPHERE_RADIUS,
                                 focal_scale=LEGO_FOCAL_SCALE, alpha=True)
    n = LEGO_TRAIN
    data["i_val"], data["i_test"] = data["i_test"][:LEGO_HELD], data["i_test"][LEGO_HELD:]
    scene = synthetic.write_blender_scene(str(tmp / "nerf_synthetic_lego"), data)
    cfg_file = tmp / "lego_cli.py"
    cfg_file.write_text(
        f"_base_ = {str(LEGO_CONFIG)!r}\nbasedir = {str(tmp / 'logs')!r}\n"
        f"data = dict(datadir={scene!r})\n"
        f"coarse_train = dict(N_iters={LEGO_COARSE_STEPS})\n"
        f"fine_train = dict(N_iters={LEGO_FINE_STEPS}, pg_scale={list(LEGO_PG_SCALE)}, "
        f"i_panel={LEGO_FINE_STEPS})\n")
    cfg = loader.load_config(str(cfg_file))
    loaded = common.load_everything(cfg)
    box = bbox_mod.compute_bbox_by_cam_frustrm(cfg, loaded, "dvgo", device="cuda")
    log(f"[9a] capture of {n} train, {LEGO_HELD} val and {LEGO_HELD} test views of "
        f"{LEGO_H}x{LEGO_W} RGBA (NeRF-synthetic layout) made, written and loaded in "
        f"{time.time() - t0:.1f} s; camera-frustum box {box[0].round(4).tolist()} .. "
        f"{box[1].round(4).tolist()}")
    return str(cfg_file)


def family_shapes(fern_box) -> dict:
    """The shapes phases 7 and 8 hand the kernels: TV on DCVGO's one-bank
    bicycle grids (bf16), on DMPIGO's fern grids (f32, the x and y axes
    weighed otherwise than z, in the train step's ratio), on Truck.py's
    seven banks, on waymo_no_block.py's (seven banks of 299^3, k0 of 3
    channels, bf16) and on grass.py's (seven banks of 319^3, f32); the
    march at DCVGO's [N_rand, 1064], DMPIGO's [N_rand, 255], waymo's
    [2048, 96] and grass.py's [4096, 1064], each with its own shift and
    interval; ``cumdist_thres`` at DCVGO's [N_rand, 1063]. Phase 9's DVGO
    shapes depend on the coarse geometry its runs find: phase 9c holds the
    kernels at the shapes those runs gave them."""
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.models import dcvgo, dmpigo
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.train import loop

    bike = loader.load_config(str(DCVGO_CONFIG))
    bfm = bike.fine_model_and_render
    dc = dcvgo.config_from(bfm, (-1.0,) * 3, (1.0,) * 3, bfm.num_voxels_rgb)
    fern = loader.load_config(str(FERN_CONFIG))
    ffm = fern.fine_model_and_render
    dm = dmpigo.config_from(ffm, *fern_box, ffm.num_voxels_rgb)
    truck = loader.load_config(str(TRUCK_HOST_CONFIG)).fine_model_and_render
    tr = fg.config_from(truck, (-1.0,) * 3, (1.0,) * 3, truck.num_voxels_density,
                        truck.num_voxels_rgb)
    banks = 2 * tr.fourier_freq_num + 1
    phase8 = {}  # 8a and 8b: waymo_no_block.py and grass.py at their full width
    for tag, path in (("waymo_no_block.py", WAYMO_CONFIG), ("grass.py", FREE_CONFIG)):
        c = loader.load_config(str(path))
        m = fg.config_from(c.fine_model_and_render, (-1.0,) * 3, (1.0,) * 3,
                           c.fine_model_and_render.num_voxels_density,
                           c.fine_model_and_render.num_voxels_rgb)
        s = m.sample_budget if 0 < m.sample_budget < 2 * m.n_inner else 2 * m.n_inner
        phase8[tag] = (m, (c.fine_train.N_rand, s))
    sx, sy, sz = loop.tv_axis_scale("dmpigo", dm)
    w3, wd = (0.3, 0.2, 0.1), (0.2 * sx, 0.2 * sy, 0.2 * sz)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    tv = [("dcvgo density", (1, *dc.world_size, 1), dt[dc.grid_dtype], w3),
          ("dcvgo k0", (1, *dc.world_size, dc.k0_dim), dt[dc.grid_dtype], w3),
          ("dmpigo density", (1, *dm.world_size, 1), torch.float32, wd),
          ("dmpigo k0", (1, *dm.world_size, dm.k0_dim), torch.float32, wd),
          ("Truck.py density", (banks, *tr.world_size_density, 1), dt[tr.grid_dtype], w3),
          ("Truck.py k0", (banks, *tr.world_size_rgb, tr.k0_dim), dt[tr.grid_dtype], w3)]
    for tag, (m, _) in phase8.items():
        nb = 2 * m.fourier_freq_num + 1
        tv += [(f"{tag} density", (nb, *m.world_size_density, 1), dt[m.grid_dtype], w3),
               (f"{tag} k0", (nb, *m.world_size_rgb, m.k0_dim), dt[m.grid_dtype], w3)]
    march = [("dcvgo", (bike.fine_train.N_rand, 2 * dc.n_inner), dc.act_shift,
              dc.stepsize * dc.voxel_size_ratio),
             ("dmpigo", (fern.fine_train.N_rand, dm.n_samples(dm.stepsize)), 0.0,
              dm.stepsize * dm.voxel_size_ratio)]
    march += [(tag, shape, m.act_shift, m.stepsize * m.voxel_size_ratio_density)
              for tag, (m, shape) in phase8.items()]
    return {"tv": tv, "march": march, "dcvgo": dc}


# a grid over this many elements is held against the plain version a bank at
# a time (the plain version's f32 temporaries of Truck.py's 2.7 G elements
# would not fit beside it)
WHOLE_CHECK_MAX = 1 << 30


def tv_by_bank_case(gen, label, shape, dtype, w) -> float:
    """``tv_add_grad`` on the whole grid, sparse and dense, out of place and
    in place, each bank against the plain version on that bank alone (TV
    does not reach across banks). Returns the max error."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv

    p = torch.empty(shape, dtype=dtype, device="cuda")
    g = torch.empty(shape, dtype=dtype, device="cuda")
    for b in range(shape[0]):  # a bank at a time: no grid-sized f32 temporary
        p[b] = torch.randn(shape[1:], generator=gen, device="cuda")
        g[b] = torch.randn(shape[1:], generator=gen, device="cuda") * (
            torch.rand(shape[1:], generator=gen, device="cuda") > 0.4)
    err = 0.0
    for dense in (False, True):
        got = tv.tv_add_grad(p, g, *w, 1.0, dense)
        torch.cuda.synchronize()
        worst = 0.0
        for b in range(shape[0]):
            ref = tv.tv_add_grad_plain(p[b:b + 1].float(), g[b:b + 1].float(), *w, 1.0, dense)
            diff = (got[b:b + 1].float() - ref).abs()
            tol = 1e-6 + 1e-5 * ref.abs()
            if dtype == torch.bfloat16:
                tol += torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 9)
            if not bool(torch.isfinite(got[b]).all()):
                raise AssertionError(f"tv {label}: non-finite kernel output in bank {b}")
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / tol).max()))
            del ref, diff, tol
        log(f"  tv {label} {tuple(shape)} {str(dtype)[6:]} dense={dense}, bank by bank: "
            f"max_abs_err {err:.3e}, worst error / its element's tolerance {worst:.3f}")
        if not worst <= 1.0:
            raise AssertionError(f"tv {label}: an element exceeds its tolerance ({worst} x)")
        g2 = g.clone()
        tv.tv_add_grad(p, g2, *w, 1.0, dense, out=g2)
        torch.cuda.synchronize()
        if not torch.equal(g2, got):
            raise AssertionError(f"tv {label} dense={dense}: in place differs from out of place")
        del got, g2
        torch.cuda.empty_cache()
    return err


def phase_tv_families(gen, shapes: dict, floor: float):
    """TV at this slice's shapes: checked (whole, or bank by bank over
    ``WHOLE_CHECK_MAX`` elements), then timed as the train step calls it, in
    place and dense, with the shape's own weights. Returns (max error, shape
    lines)."""
    import math

    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms, time_ms

    err, lines = 0.0, []
    for label, shape, dtype, w in shapes["tv"]:
        n = math.prod(shape)
        if n > WHOLE_CHECK_MAX:
            err = max(err, tv_by_bank_case(gen, label, shape, dtype, w))
        else:
            err = max(err, tv_case(gen, label, shape, dtype, w))
        torch.cuda.empty_cache()
        p = torch.empty(shape, dtype=dtype, device="cuda")
        g = torch.empty(shape, dtype=dtype, device="cuda")
        for b in range(shape[0]):
            p[b] = torch.randn(shape[1:], generator=gen, device="cuda")
            g[b] = torch.randn(shape[1:], generator=gen, device="cuda")
        ms, call_ms = kernel_ms(lambda: tv.tv_add_grad(p, g, *w, 1.0, True, out=g))
        if n > WHOLE_CHECK_MAX:  # the plain version a bank at a time, the banks summed
            plain = sum(time_ms(lambda: tv.tv_add_grad_plain(p[b:b + 1], g[b:b + 1], *w, 1.0,
                                                             True), iters=3, warmup=1)
                        for b in range(shape[0]))
        else:
            plain = time_ms(lambda: tv.tv_add_grad_plain(p, g, *w, 1.0, True), iters=5)
        bnd = bound_ms(3 * n * p.element_size(), 25 * n)[0]
        line = shape_line(f"tv_add_grad {label} {tuple(shape)} {str(dtype)[6:]} in place, "
                          f"weights {tuple(round(x, 4) for x in w)}", ms, call_ms, bnd, floor)
        line["plain_ms"] = plain
        log(f"[3]   plain version {plain:.3f} ms")
        lines.append(line)
        del p, g
        torch.cuda.empty_cache()
    return err, lines


def march_case(gen, label: str, shape, shift: float, interval: float, floor: float,
               train: bool):
    """Both march kernels at ``shape`` with ``shift`` and ``interval``: the
    forward against the plain version, the no-grad forward against the one
    that keeps residuals, the backward against the plain version within
    ``march_backward_tolerance``; then timed as the train step launches them
    (``train``: the forward keeps residuals, and the backward) or as a render
    chunk does (the no-grad forward). Returns (forward error, backward error,
    forward shape line, backward shape line or None)."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import march
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms

    d, mask = march_inputs(gen, shape)
    res = march.march_forward(d, mask, shift, interval)
    torch.cuda.synchronize()
    err_f = check_march_forward(f"march_forward {label} {list(shape)}", res, d, mask, shift,
                                interval)
    with torch.no_grad():
        lean = march.fused_alpha2weights(d, mask, shift, interval)
    torch.cuda.synchronize()
    for a, b in zip(lean, res[:3]):
        if not torch.equal(a, b):
            raise AssertionError(f"march_forward {label} {list(shape)}: the no-grad "
                                 "forward differs from the one that keeps residuals")
    w, ai, alpha, t_excl = res
    gw = torch.randn(shape, generator=gen, device="cuda")
    gl = torch.randn(shape[:1], generator=gen, device="cuda")
    args = (alpha, t_excl, ai, gw, gl, shift, interval, d, mask)
    gd = march.march_backward(*args)
    torch.cuda.synchronize()
    err_b = check_within(f"march_backward {label} {list(shape)}", gd,
                         march.march_backward_plain(*args),
                         march.march_backward_tolerance(*args))
    n, ns = shape[0], shape[0] * shape[1]
    b_line = None
    if train:  # the train step: the forward keeps residuals
        ms, call = kernel_ms(lambda: march.march_forward(d, mask, shift, interval))
        bnd = bound_ms(ns * (4 + 1 + 3 * 4) + n * 4, 25 * ns)[0]
        f_line = shape_line(f"march_forward {label} at the train step's {list(shape)}, "
                            "residuals kept", ms, call, bnd, floor)
        ms, call = kernel_ms(lambda: march.march_backward(*args))
        bnd = bound_ms(ns * (4 * 4 + 1 + 4) + 2 * n * 4, 30 * ns)[0]
        b_line = shape_line(f"march_backward {label} {list(shape)}", ms, call, bnd, floor)
    else:  # a render chunk: no gradient
        def lean_call():
            with torch.no_grad():
                return march.fused_alpha2weights(d, mask, shift, interval)

        ms, call = kernel_ms(lean_call)
        bnd = bound_ms(ns * (4 + 1 + 2 * 4) + n * 4, 25 * ns)[0]
        f_line = shape_line(f"march_forward {label} at a render chunk's {list(shape)}, no "
                            "gradient", ms, call, bnd, floor)
    del d, mask, res, lean, gw, gl, args, gd
    torch.cuda.empty_cache()
    return err_f, err_b, f_line, b_line


def phase_march_families(gen, shapes: dict, floor: float):
    """Both march kernels (``march_case``) at each family's train shape (with
    its own shift and interval) and at a render chunk of it. Returns (forward
    error, backward error, forward shape lines, backward shape lines)."""
    err_f = err_b = 0.0
    f_lines, b_lines = [], []
    for label, (N, S), shift, interval in shapes["march"]:
        for shape in ((N, S), (RENDER_CHUNK, S)):
            ef, eb, f_line, b_line = march_case(gen, label, shape, shift, interval, floor,
                                                train=shape == (N, S))
            err_f, err_b = max(err_f, ef), max(err_b, eb)
            f_lines.append(f_line)
            b_lines += [b_line] if b_line else []
    return err_f, err_b, f_lines, b_lines


def cumdist_inputs(gen, n: int, dc):
    """The step distances of DCVGO's contracted samples on ``n`` seeded rays
    from around the scene box, looking roughly at it, and the threshold: as
    ``dcvgo.oversample_mask`` hands them to the kernel."""
    import torch

    from unboundednerfpytorch_tpu_torch.models import dcvgo

    ro = torch.randn((n, 3), generator=gen, device="cuda") * 1.5
    rd = torch.randn((n, 3), generator=gen, device="cuda") * 0.5 - ro
    pts, _, _ = dcvgo.sample_ray(dc, ro, rd)
    diff = pts[:, 1:] - pts[:, :-1]
    dist = torch.sqrt((diff * diff).sum(-1))
    return dist, (2 + 2 * dc.bg_len) / dc.world_len * dc.stepsize * 0.95


def phase_cumdist(gen, shapes: dict, floor: float) -> dict:
    """``cumdist_thres`` against its plain version (the loop over samples of
    ``ops/sampling.py``, on the card): the flags must be equal, at DCVGO's
    train and render shapes, at ragged ones (a ray, no ray, S of 1 and
    around a warp of 32) and on adversarial distances; then timed."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops import sampling
    from unboundednerfpytorch_tpu_torch.ops.cuda.ub360 import cumdist_thres
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms, time_ms

    dc = shapes["dcvgo"]
    n_train = shapes["march"][0][1][0]
    cases = []
    for n, s in ((37, 33), (33, 95), (1, 1), (0, 5), (70, 200), (5, 31)):
        dist = torch.rand((n, s), generator=gen, device="cuda") * 0.01
        dist[::5, s // 3:] = 0.0
        cases.append((f"ragged {[n, s]}", dist, 0.0061))
    # adversarial: sums that run across the kernel's pieces of 128 samples and
    # its blocks of 32 rays before they pass the threshold, tails of zeros,
    # distances exactly at the threshold (never over it alone) and at half
    # of it, and a tensor that starts 4 bytes past a 16-byte boundary
    thres = 0.0061
    at = float(torch.tensor(thres, dtype=torch.float32))
    long_runs = torch.rand((65, 1063), generator=gen, device="cuda") * (thres / 60)
    cases.append(("runs across pieces and blocks [65, 1063]", long_runs, thres))
    tail = torch.rand((33, 1063), generator=gen, device="cuda") * 0.01
    tail[:, 517:] = 0.0
    cases.append(("zero tails [33, 1063]", tail, thres))
    exact = torch.full((37, 300), at, device="cuda")
    exact[1::2] = at / 2
    cases.append(("distances at and at half the threshold [37, 300]", exact, thres))
    store = torch.rand((33 * 257 + 1,), generator=gen, device="cuda") * 0.01
    cases.append(("a view 4 bytes into its storage [33, 257]", store[1:].view(33, 257), thres))
    for what, n in (("train step", n_train), ("render chunk", RENDER_CHUNK)):
        dist, thres = cumdist_inputs(gen, n, dc)
        cases.append((f"{what} {list(dist.shape)}", dist, thres))
    for name, dist, thres in cases:
        got = cumdist_thres(dist, thres)
        want = sampling.cumdist_thres_plain(dist, thres)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != torch.bool or not torch.equal(got, want):
            raise AssertionError(f"cumdist_thres {name}: the flags differ from the plain "
                                 f"version's on {int((got != want).sum())} samples")
        log(f"  cumdist_thres {name}: equal to the plain version ({int(want.sum())} of "
            f"{want.numel()} flags set)")
    lines, total = [], {"ms": 0.0, "plain": 0.0, "bound": 0.0}
    for name, dist, thres in cases[-2:]:
        ms, call = kernel_ms(lambda: cumdist_thres(dist, thres))
        plain = time_ms(lambda: sampling.cumdist_thres_plain(dist, thres), iters=3, warmup=1)
        bnd, by = bound_ms(dist.numel() * (4 + 1), 3 * dist.numel())
        lines.append(shape_line(f"cumdist_thres {name}", ms, call, bnd, floor))
        log(f"[3]   plain version {plain:.3f} ms")
        total["ms"] += ms
        total["plain"] += plain
        total["bound"] += bnd
    return {"name": "cumdist_thres", "route": "cuda",
            "source": "unboundednerfpytorch_tpu_torch/csrc/ub360.cu",
            "replaces": "unboundednerfpytorch_tpu/ops/sampling.py:202", "max_abs_err": 0.0,
            "ms": total["ms"], "plain_ms": total["plain"], "bound_ms": total["bound"],
            "bound_by": by, "library_ms": None, "floor_ms": floor, "shapes": lines}


# ---------------------------------------------------------------------------
# masked Adam (phase 3)

# element counts that leave a scalar tail after the 16-byte vectors (8 bf16
# or 4 f32 a vector), a tensor smaller than a vector, one element
ADAM_RAGGED_SIZES = (1, 7, 8 * 1000 - 1, 8 * 1000 + 1, 4 * 1000 + 3)
ADAM_SLICE = 1 << 26  # the plain version's slice on the card (its temporaries)


SECTOR = 32  # bytes the memory moves at a time


def live_sectors(g, per: int, skip: bool) -> int:
    """Sectors of ``per`` elements, aligned with the tensor's start, that
    hold a non-zero element of ``g`` (all of them without the skip)."""
    n = g.numel()
    if not skip:
        return -(-n // per)
    nz = (g != 0).reshape(-1)
    whole = n // per * per
    return int(nz[:whole].view(-1, per).any(1).sum()) + int(bool(nz[whole:].any()))


def adam_bank_inputs(seed: int, shape, dtype, sparse: bool):
    """(p, g, m, v) of one bank, made from ``seed``: p and g in ``dtype``,
    g zero at 40% of the elements where ``sparse``, moments f32 (v >= 0)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda")
    if sparse:
        g *= torch.rand(shape, generator=gen, device="cuda") > 0.4
    m = torch.randn(shape, generator=gen, device="cuda") * 0.1
    v = torch.rand(shape, generator=gen, device="cuda") * 0.01
    return p, g.to(dtype), m, v


def bits(x):
    import torch

    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def lr_inputs(seed: int, shape):
    """A per-element lr as ``pervoxel_lr`` makes it, from ``seed``: view
    counts over their maximum, 0 at a fifth of the elements."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    count = torch.randint(0, 21, shape, generator=gen, device="cuda").float()
    count *= torch.rand(shape, generator=gen, device="cuda") > 0.2
    return count / count.max().clamp_min(1.0)


def cold_ms(fn, iters: int = 20) -> float:
    """Device ms of ``fn`` (one launch) with the 50 MB L2 cache flushed
    before each call, as the train step leaves it for its one update of a
    grid: CUDA events around each call just after a 256 MB fill, the mean
    over ``iters`` after a warm-up. A spin of about a millisecond between
    the fill and the first event keeps the card busy while the host makes
    the call, so the events time the kernel and not the host's launch."""
    import torch

    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    total = 0.0
    for i in range(iters + 2):
        flush.fill_(float(i))
        torch.cuda._sleep(2_000_000)  # cycles: about 1 ms at the H100's clock
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 2:
            total += start.elapsed_time(end)
    del flush
    return total / iters


def adam_case(label: str, shape, dtype, skip: bool, grad: bool = True,
              offsets=(0, 0, 0, 0, 0), per_lr: bool = False) -> int:
    """``masked_adam`` over a whole tensor of ``shape`` (its leading axis a
    bank), then each bank held bit-equal to the plain version on that bank,
    made again from its seed (a bank at a time: the plain version's copy of
    a 2.7 G-element state would not fit beside it). ``offsets``: p, g, m, v
    and the per-element lr are views that start that many elements into
    their storage. With ``per_lr`` the update takes a per-element lr (and
    launches whatever ``skip`` and ``grad`` say). Returns the kernel's
    launches (0 for a skip group without a grad or lr)."""
    import math

    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import adam, build

    banks, bank = shape[0], tuple(shape[1:])
    n = math.prod(shape)

    def alloc(dt, offset):
        return torch.empty(n + offset, dtype=dt, device="cuda")[offset:].view(shape)

    offsets = tuple(offsets) + (0,) * (5 - len(offsets))
    p, g, m, v, r = (alloc(dt, o) for dt, o in zip(
        (dtype, dtype, torch.float32, torch.float32, torch.float32), offsets))
    for b in range(banks):
        for dst, src in zip((p, g, m, v), adam_bank_inputs(1000 + b, bank, dtype, skip)):
            dst[b] = src
        r[b] = lr_inputs(3000 + b, bank)
    key = "masked_adam_per_lr" if per_lr else "masked_adam"
    before = build.LAUNCHES[key]
    step_size = 0.1 * 0.7 * (0.1 / 0.01)  # lr 0.1, lr_scale 0.7, the bias correction of step 1
    adam.masked_adam(p, m, v, g if grad else None, step_size, 0.9, 0.99, 1e-8, skip,
                     per_lr=r if per_lr else None)
    torch.cuda.synchronize()
    launched = build.LAUNCHES[key] - before
    for b in range(banks):
        p0, g0, m0, v0 = adam_bank_inputs(1000 + b, bank, dtype, skip)
        adam.masked_adam_plain(p0, m0, v0, g0 if grad else None, step_size, 0.9, 0.99, 1e-8,
                               skip, ADAM_SLICE, per_lr=lr_inputs(3000 + b, bank) if per_lr
                               else None)
        for what, got, want in (("p", p[b], p0), ("m", m[b], m0), ("v", v[b], v0)):
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(
                    f"masked_adam {label} bank {b}: {what} differs from the plain version on "
                    f"{int((bits(got) != bits(want)).sum())} of {want.numel()} elements")
        del p0, g0, m0, v0
    log(f"  {key} {label} {tuple(shape)} {str(dtype)[6:]} skip={skip} grad={grad}"
        f"{f' offsets {offsets}' if any(offsets) else ''}: p, m and v bit-equal to the plain version"
        f"{' bank by bank' if banks > 1 else ''} ({launched} launch)")
    del p, g, m, v, r
    torch.cuda.empty_cache()
    return launched


def adam_shapes(tv_shapes: dict, fam: dict) -> list:
    """(label, shape, dtype, skip) of the parameters the train steps of
    phases 4 to 8 update: bicycle_single's, bicycle.py's (DCVGO), fern.py's
    (DMPIGO, f32) and Truck.py's, waymo_no_block.py's and grass.py's grids,
    and an f32 MLP weight, as they hand them to the optimizer."""
    import torch

    out = [(f"bicycle_single {k}", s, torch.bfloat16, True) for k, s in tv_shapes.items()]
    out += [(label, shape, dtype, True) for label, shape, dtype, _ in fam["tv"]]
    out.append(("rgbnet weight", (1, 128, 128), torch.float32, False))
    return out


def adam_row(name: str, replaces: str, floor: float) -> dict:
    """A row of the kernel table for ``masked_adam`` (or its per-element-lr
    launches), its times summed over the shape lines ``adam_time`` adds."""
    return {"name": name, "route": "cuda", "source": "unboundednerfpytorch_tpu_torch/csrc/adam.cu",
            "replaces": replaces, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None, "floor_ms": floor,
            "bound_ms_elementwise": 0.0, "shapes": []}


def adam_time(row: dict, label: str, shape, dtype, skip: bool, per_lr: bool,
              floor: float) -> None:
    """Time ``masked_adam`` on seeded inputs of ``shape`` against its bound
    and its plain version, and add the shape's line and times to ``row``.
    The device time is one launch with the 50 MB L2 cache flushed before it
    (``cold_ms``), as the train step, which updates a tensor once between
    GBs of other work, leaves the cache; back-to-back launches would find a
    tensor under about 50 MB in the cache. Where the bound lies under the
    launch floor (a tensor of under about 1 MB), the launch and not the
    memory sets the time, and one launch between two events would time the
    events: such a row is timed by the many-launch method. The bound: a
    skip group reads g in full and p, m and v where g is not 0, by element
    and by the 32-byte DRAM sectors that hold a non-zero g (p's sectors hold
    32 / es elements, m's and v's 8), which is what the memory moves; with a
    per-element lr every element is read and written (p, g, m, v and the lr
    read, p, m and v written)."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import adam
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms, time_ms

    banks, bank = shape[0], tuple(shape[1:])
    p, g, m, v = (torch.empty(shape, dtype=dt, device="cuda")
                  for dt in (dtype, dtype, torch.float32, torch.float32))
    for b in range(banks):
        for dst, src in zip((p, g, m, v), adam_bank_inputs(2000 + b, bank, dtype, skip)):
            dst[b] = src
    r = lr_inputs(4000, shape) if per_lr else None
    n, es = p.numel(), p.element_size()
    if per_lr:
        live = n
        n_bytes = n_bytes_elementwise = n * (3 * es + 8 + 8 + 4)
    else:
        live = int((g != 0).sum()) if skip else n
        n_bytes_elementwise = n * es + live * (2 * es + 16)
        n_bytes = SECTOR * (-(-n * es // SECTOR) + 2 * live_sectors(g, SECTOR // es, skip)
                            + 4 * live_sectors(g, SECTOR // 4, skip))
    update = lambda: adam.masked_adam(p, m, v, g, 1e-3, 0.9, 0.99, 1e-8, skip, per_lr=r)
    plain = time_ms(lambda: adam.masked_adam_plain(p, m, v, g, 1e-3, 0.9, 0.99, 1e-8, skip,
                                                    ADAM_SLICE, per_lr=r), iters=3, warmup=1)
    bnd = bound_ms(n_bytes, (11 if per_lr else 10) * live)[0]
    bnd_elementwise = bound_ms(n_bytes_elementwise, (11 if per_lr else 10) * live)[0]
    if bnd < floor:  # the launch bounds it, not the memory: many launches in a graph
        ms, call = kernel_ms(update)
        how = "launch-bound, back to back"
    else:
        call = time_ms(update)
        ms = cold_ms(update)
        how = "L2 flushed"
    what = (f"skip={skip}, {100 * live / n:.0f}% of g non-zero" if not per_lr
            else "per-element lr")
    line = shape_line(f"{row['name']} {label} {tuple(shape)} {str(dtype)[6:]} {what}, {how}",
                      ms, call, bnd, floor)
    log(f"[3]   plain version {plain:.3f} ms; bound by sectors {bnd:.4f} ms "
        f"({n_bytes / 1e9:.4f} GB), by elements {bnd_elementwise:.4f} ms "
        f"({n_bytes_elementwise / 1e9:.4f} GB); the kernel moves the sectors' bytes at "
        f"{n_bytes / ms / 1e6:.0f} GB/s")
    line.update(plain_ms=plain, bound_ms_elementwise=bnd_elementwise)
    row["shapes"].append(line)
    row["ms"] += ms
    row["plain_ms"] += plain
    row["bound_ms"] += bnd
    row["bound_ms_elementwise"] += bnd_elementwise
    del p, g, m, v, r
    torch.cuda.empty_cache()


def phase_adam(gen, tv_shapes: dict, fam: dict, floor: float) -> list:
    """``masked_adam`` against its plain version, bit for bit (p, m and v),
    at every parameter shape of phases 4 to 8, without a grad, and at ragged
    sizes and an unaligned start; then timed at each of those shapes. With a
    per-element lr (``masked_adam_per_lr``) at ragged sizes and on unaligned
    views; phase 9c holds both, and times them, at the shapes the DVGO runs
    give them. Returns both rows of the kernel table (the second without
    times until phase 9c)."""
    import torch

    shapes = adam_shapes(tv_shapes, fam)
    for label, shape, dtype, skip in shapes:
        adam_case(label, shape, dtype, skip)
    for skip in (True, False):
        if adam_case("no grad", (1, 1000, 3), torch.float32, skip, grad=False) != (not skip):
            raise AssertionError("masked_adam: a parameter without a grad launched "
                                 f"{'a kernel' if skip else 'no kernel'} with skip={skip}")
    for n in ADAM_RAGGED_SIZES:
        for dtype in (torch.bfloat16, torch.float32):
            for skip in (True, False):
                adam_case("ragged", (1, n), dtype, skip)
    # views that start inside a vector: p, g, m and v at the same element
    # (a scalar head, then vectors), or not (one element a thread throughout)
    for offsets in ((1, 1, 1, 1), (3, 3, 3, 3), (1, 0, 0, 0), (0, 0, 2, 0)):
        for dtype in (torch.bfloat16, torch.float32):
            adam_case("unaligned", (1, 8 * 1000 + 5), dtype, True, offsets=offsets)
    # with a per-element lr: at ragged sizes and on unaligned views (the lr's
    # own among them), with the skip asked for (it does not apply: every
    # element moves) and without a grad
    for n in ADAM_RAGGED_SIZES:
        for dtype in (torch.bfloat16, torch.float32):
            for skip, grad in ((False, True), (True, True), (True, False)):
                if adam_case("ragged", (1, n), dtype, skip, grad=grad, per_lr=True) != 1:
                    raise AssertionError("masked_adam with per_lr: no launch")
    for offsets in ((1, 1, 1, 1, 1), (3, 3, 3, 3, 3), (0, 0, 0, 0, 1), (2, 2, 2, 2, 0)):
        for dtype in (torch.bfloat16, torch.float32):
            adam_case("unaligned", (1, 8 * 1000 + 5), dtype, False, offsets=offsets,
                      per_lr=True)
    row = adam_row("masked_adam", "unboundednerfpytorch_tpu/optim/masked_adam.py:83", floor)
    for label, shape, dtype, skip in shapes:
        adam_time(row, label, shape, dtype, skip, False, floor)
    lr_row = adam_row("masked_adam_per_lr", "unboundednerfpytorch_tpu/optim/masked_adam.py:148",
                      floor)
    lr_row.update(ms=None, plain_ms=None, bound_ms=None, bound_ms_elementwise=None)
    return [row, lr_row]


class PathShapes:
    """For a ``with`` block, the signatures the path hands ``march_forward``
    (shape, shift, interval, whether it keeps residuals), ``march_backward``
    (shape, shift, interval), ``masked_adam`` (shape, dtype, skip, whether
    a grad and a per-element lr came) and the train step's ``tv_add_grad``
    (shape, dtype, weights), each with its number of calls: spies on the
    wrappers that read their arguments and hold none."""

    def __init__(self):
        self.fwd, self.bwd, self.adam, self.tv = {}, {}, {}, {}

    def __enter__(self):
        from unboundednerfpytorch_tpu_torch.ops.cuda import adam, march
        from unboundednerfpytorch_tpu_torch.train import step

        def count(table, key):
            table[key] = table.get(key, 0) + 1

        def on_fwd(args, kwargs):
            d, _, shift, interval = args[:4]
            residuals = kwargs.get("residuals", args[4] if len(args) > 4 else True)
            count(self.fwd, (tuple(d.shape), float(shift), float(interval), bool(residuals)))

        def on_bwd(args, kwargs):
            count(self.bwd, (tuple(args[7].shape), float(args[5]), float(args[6])))

        def on_adam(args, kwargs):
            p, grad, skip = args[0], args[3], args[8]
            count(self.adam, (tuple(p.shape), p.dtype, bool(skip), grad is not None,
                              kwargs.get("per_lr") is not None))

        def on_tv(args, kwargs):
            count(self.tv, (tuple(args[0].shape), args[0].dtype,
                            tuple(float(w) for w in args[2:5])))

        self.spies = [Spy(march, "march_forward", before=on_fwd, keep=False),
                      Spy(march, "march_backward", before=on_bwd, keep=False),
                      Spy(adam, "masked_adam", before=on_adam, keep=False),
                      Spy(step, "tv_add_grad", before=on_tv, keep=False)]
        for spy in self.spies:
            spy.__enter__()
        return self

    def __exit__(self, *exc):
        for spy in reversed(self.spies):
            spy.__exit__(*exc)


def phase_dvgo_kernels(gen, kernels: list, paths: dict, floor: float, per_lr: tuple = (),
                       seen: set | None = None) -> None:
    """Phases 9c and 10f: the kernels at the shapes the runs of phases 9 and
    10 gave them (``paths``: tag -> ``PathShapes``), which depend on the
    coarse geometry they found (the fine box, and the samples a ray on it):
    both march kernels at each [N, S] with its shift and interval
    (``march_case``), ``masked_adam`` bit for bit at each parameter's shape,
    dtype and skip, with and without a grad where the run gave a
    per-element lr. Every path must have launched both march kernels, and
    each path of ``per_lr`` ``masked_adam`` with and without a per-element
    lr. A signature in ``seen`` (shared across calls) is held and timed
    once. Each line goes into the rows of ``kernels``."""
    import torch

    rows = {k["name"]: k for k in kernels}
    seen = set() if seen is None else seen
    for tag, shapes in paths.items():
        if not (shapes.fwd and shapes.bwd) or (tag in per_lr and not (
                any(k[4] for k in shapes.adam) and not all(k[4] for k in shapes.adam))):
            raise AssertionError(f"{tag}: a kernel saw no shape: march {shapes.fwd}, "
                                 f"{shapes.bwd}, adam {shapes.adam}")
        if not set(shapes.bwd) <= {k[:3] for k in shapes.fwd if k[3]}:
            raise AssertionError(f"{tag}: march_backward at {shapes.bwd} without its forward")
        log(f"[9c/10f] {tag}: {len(shapes.fwd)} march_forward shapes, {len(shapes.bwd)} "
            f"march_backward, {len(shapes.adam)} masked_adam "
            f"({sum(k in seen for k in (*shapes.fwd, *shapes.adam))} held already)")
        for key, n in shapes.fwd.items():
            if key in seen:
                continue
            seen.add(key)
            shape, shift, interval, train = key
            ef, eb, f_line, b_line = march_case(gen, f"{tag} ({n} calls)", shape, shift,
                                                interval, floor, train)
            for name, err, line in (("march_forward", ef, f_line), ("march_backward", eb, b_line)):
                if line is not None:
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
                    rows[name]["shapes"].append(line)
        for key, n in shapes.adam.items():
            if key in seen:
                continue
            seen.add(key)
            shape, dtype, skip, grad, with_lr = key
            label = f"{tag} ({n} calls)"
            # the whole tensor as one bank: the path's shapes hold one bank
            one = (1, *shape) if shape[0] != 1 else shape
            for with_grad in ((True, False) if with_lr else (grad,)):
                adam_case(label, one, dtype, skip, grad=with_grad, per_lr=with_lr)
            if with_lr and rows["masked_adam_per_lr"]["ms"] is None:
                rows["masked_adam_per_lr"].update(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                                  bound_ms_elementwise=0.0)
            adam_time(rows["masked_adam_per_lr" if with_lr else "masked_adam"], label, one,
                      dtype, skip, with_lr, floor)
        torch.cuda.empty_cache()


def full_width_ms(records, first: int, last: int) -> list:
    """ms of steps first..last by the loop's clock (``elapsed_s``)."""
    steps = {r["step"]: r for r in records if "loss" in r}
    return [1e3 * (steps[s]["elapsed_s"] - steps[s - 1]["elapsed_s"])
            for s in range(first, last + 1)]


def check_family_records(tag: str, records: list, family: str, world_size: tuple,
                         exp_dir: str | None = None) -> list:
    """The loop's records of a family's command-line run (``read_records``,
    or ``Records`` of a run without a checkpoint): both boundaries crossed,
    every step logged with a finite loss, the grids at ``world_size`` after
    the last boundary; with ``exp_dir``, ``fine_last`` at the last step.
    Returns the records."""
    import numpy as np

    bounds = {r["step"]: r["pg_scale"] for r in records if "pg_scale" in r}
    steps = [r for r in records if "loss" in r]
    if sorted(bounds) != list(CLI_PG_SCALE) or [r["step"] for r in steps] != list(
            range(1, FAMILY_STEPS + 1)):
        raise AssertionError(f"{tag} records: boundaries {sorted(bounds)}, steps "
                             f"{[r['step'] for r in steps]}")
    if not all(np.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"{tag}: a loss is not finite")
    last = bounds[CLI_PG_SCALE[-1]]
    if tuple(last["world_size_density"]) != tuple(world_size) or \
            tuple(last["world_size_rgb"]) != tuple(world_size):
        raise AssertionError(f"{tag}: grids {last['world_size_rgb']} after the last boundary, "
                             f"want {world_size}")
    if exp_dir is None:
        return records
    meta = json.load(open(os.path.join(exp_dir, "fine_last", "meta.json")))
    if (meta["family"], meta["global_step"]) != (family, FAMILY_STEPS):
        raise AssertionError(f"{tag}: fine_last holds {meta['family']} at step "
                             f"{meta['global_step']}")
    return records


def phase_cli_dcvgo(tmp: pathlib.Path, card: str) -> list:
    """Phase 7a: bicycle.py (DCVGO)'s command-line train on a capture at
    images_4, without its checkpoint (``cli_train_in_memory``: the disk is
    kept for phase 13a), then its render's forward held on the trained
    model: cached against uncached and the card against the CPU. Returns the
    launch counts of the run."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
    from unboundednerfpytorch_tpu_torch.convert import params_from_numpy, params_to_numpy
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.models import dcvgo
    from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop

    t0 = time.time()
    data = synthetic.orbit_scene(BIKE4_VIEWS, BIKE4_H, BIKE4_W, seed=2, cam_radius=CAM_RADIUS,
                                 sphere_radius=SPHERE_RADIUS)
    scene = synthetic.write_llff_scene(str(tmp / "360_v2_bicycle_4"), data, factor=4)
    cfg_file = write_config(tmp / "dcvgo_cli.py", DCVGO_CONFIG, scene, tmp / "logs",
                            FAMILY_STEPS)
    cfg = loader.load_config(cfg_file)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    full = dcvgo.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_rgb)
    log(f"[7a] config {DCVGO_CONFIG.relative_to(ROOT)} (DCVGO): {full.world_size} voxels, "
        f"k0 {full.k0_dim} channels {full.grid_dtype}, rgbnet {fm.rgbnet_dim}/{fm.rgbnet_width}, "
        f"N_rand {ft.N_rand}, {2 * full.n_inner} samples a ray, pg_scale {ft.pg_scale}; scene "
        f"of {BIKE4_VIEWS} views of {BIKE4_H}x{BIKE4_W} made and written in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    load, records, (family, mcfg, params), render = cli_train_in_memory(
        "[7a]", cfg_file, ["--i_print", "1", "--render_test"])
    total_s = time.time() - t0
    counts = check_cli_run("[7a]", dict(build.LAUNCHES), render, FAMILY_STEPS, 1,
                           (BIKE4_H, BIKE4_W), per_step=DCVGO_PER_STEP, per_chunk=DCVGO_PER_CHUNK)
    records = check_family_records("[7a]", records, "dcvgo", full.world_size)
    if family != "dcvgo" or tuple(params.density.world_size) != tuple(full.world_size):
        raise AssertionError(f"[7a] trained {family} at {params.density.world_size}")
    ms = full_width_ms(records, CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS, FAMILY_STEPS)
    log(f"[7a] bicycle.py on {card}: grids {full.world_size} from step {CLI_PG_SCALE[-1]}; "
        f"ms/step by the callback's clock "
        f"{[round(t, 1) for t in full_width_ms(records, 2, FAMILY_STEPS)]} (steps 2 on), at full "
        f"width median {float(np.median(ms)):.1f}; peak memory of the training "
        f"{render.peak_before_gb:.2f} GB, of the whole run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; load, train and render "
        f"{total_s:.1f} s, no checkpoint")

    # ---- the render's forward on the trained model with the scene
    # imprinted: cached against the grids, and the card against the CPU
    loaded = load.result
    params.requires_grad_(False)
    synthetic.imprint_scene(params, mcfg.scene_center, mcfg.scene_radius, seed=0,
                            sphere_radius=sphere_radius_of(loaded))
    mcfg = dataclasses.replace(mcfg, fast_color_thres=normalize_fast_color_thres(fm)[1][-1][1])
    fwd = loop.make_forward(mcfg, {"near": float(loaded["near"]), "bg": 1.0,
                                   "stepsize": fm.stepsize})
    cache = dcvgo.build_render_cache(params, mcfg, log_fn=lambda m: log(f"[7a] {m}"))
    idx = int(loaded["i_test"][0])
    ro, rd, vd = (x.reshape(-1, 3) for x in ray_ops.get_rays_of_a_view(
        BIKE4_H, BIKE4_W, torch.as_tensor(loaded["Ks"][idx], device="cuda"),
        torch.as_tensor(loaded["poses"][idx][:3, :4], device="cuda")))
    mid = (BIKE4_H // 2) * BIKE4_W  # rows through the ball
    sl = slice(mid, mid + RENDER_CHUNK)
    fields = ("rgb_marched", "depth", "alphainv_last", "weights")

    def held(tag, got, ref, thres):
        """Samples that pass ``thres`` on one side only are counted and
        bounded; their rays get two thresholds' worth, the others 1e-5 +
        1e-4 relative."""
        flipped = got.mask.cpu() != ref.mask.cpu()
        n_flipped = int(flipped.sum())
        log(f"[7a] {tag}: {n_flipped} of {flipped.numel()} samples pass fast_color_thres "
            f"{thres:g} on one side only, on {int(flipped.any(-1).sum())} rays; "
            f"{int((ref.alphainv_last < 0.01).sum())} of {flipped.shape[0]} rays end on the ball")
        if n_flipped > max(1, MAX_FLIPPED_SHARE * flipped.numel()):
            raise AssertionError(f"{tag}: {n_flipped} samples differ in the threshold mask")
        same = ~flipped.any(-1)
        for f in fields:
            g, r = getattr(got, f).cpu(), getattr(ref, f).cpu()
            check(f"{tag} {f}, rays of equal masks", g[same], r[same], 1e-4, 1e-5)
            if n_flipped:
                check(f"{tag} {f}, rays of a flipped sample", g[~same], r[~same], 1e-4,
                      2 * thres)

    with torch.no_grad():
        build.reset_launch_counts()
        cached = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=cache)
        if dict(build.LAUNCHES) != {"march_forward": 1, "cumdist_thres": 1}:
            raise AssertionError(f"a render chunk launched {dict(build.LAUNCHES)}")
        held(f"cached vs uncached render, a chunk of {RENDER_CHUNK} rays of view {idx}", cached,
             fwd(params, ro[sl], rd[sl], vd[sl], None, cache=None), mcfg.fast_color_thres)
        t0 = time.time()
        cpu_params = params_from_numpy("dcvgo", params_to_numpy(params), "cpu")
        for name in ("density", "k0"):
            grid = getattr(cpu_params, name).grid
            grid.data = grid.data.to(getattr(params, name).grid.dtype)
        cpu_params.requires_grad_(False)
        cpu_cache = cache.cpu()
        cs = slice(mid + BIKE4_W // 2 - CPU_RAYS // 2, mid + BIKE4_W // 2 + CPU_RAYS // 2)
        for occupancy in ("the scene's occupancy", "all-true occupancy"):
            if occupancy.startswith("all"):
                for p_ in (params, cpu_params):
                    p_.mask_cache.mask = torch.ones_like(p_.mask_cache.mask)
            got = fwd(params, ro[cs], rd[cs], vd[cs], None, cache=cache)
            ref = fwd(cpu_params, ro[cs].cpu(), rd[cs].cpu(), vd[cs].cpu(), None,
                      cache=cpu_cache)
            held(f"cached render, card vs CPU, {CPU_RAYS} rays, {occupancy}", got, ref,
                 mcfg.fast_color_thres)
    log(f"[7a] card-vs-CPU comparison took {time.time() - t0:.1f} s")
    return counts


def phase_cli_fern(cfg_file: str, card: str) -> list:
    """Phase 7b: fern.py (DMPIGO, NDC rays) through the command line on the
    forward-facing capture, then the render of its test views. Returns the
    launch counts of the run."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    cfg = loader.load_config(cfg_file)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with render_spy() as renders, Spy(ckpt, "save_model") as saves:
        run_cli(["--config", cfg_file, "--i_print", "1", "--render_test"])
    total_s = time.time() - t0
    n_test = len(renders.calls[-1].result["test"]["psnrs"])
    counts = check_cli_run("[7b]", dict(build.LAUNCHES), renders.calls[-1], FAMILY_STEPS, n_test,
                           (FERN_H, FERN_W))
    mcfg = saves.calls[-1].args[2]
    params = saves.calls[-1].args[3]
    ws = mcfg.world_size
    records = check_family_records("[7b]", read_records(exp_dir), "dmpigo", ws, exp_dir)
    if ws[2] != fm.mpi_depth or tuple(params.k0.grid.shape) != (1, *ws, fm.rgbnet_dim) or \
            params.k0.grid.dtype != torch.float32:
        raise AssertionError(f"[7b] k0 grid {tuple(params.k0.grid.shape)} "
                             f"{params.k0.grid.dtype}, want [1, X, Y, {fm.mpi_depth}, "
                             f"{fm.rgbnet_dim}] f32")
    sx, sy, sz = loop.tv_axis_scale("dmpigo", mcfg)
    if not sx == sy != sz:
        raise AssertionError(f"[7b] TV axis scales {(sx, sy, sz)}")
    ms = full_width_ms(records, CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS, FAMILY_STEPS)
    log(f"[7b] fern.py on {card}: grids {ws}, k0 {fm.rgbnet_dim} channels f32, "
        f"{mcfg.n_samples(mcfg.stepsize)} samples a ray, TV scales x y z "
        f"{(round(sx, 4), round(sy, 4), round(sz, 4))}; ms/step by the loop's clock "
        f"{[round(t, 1) for t in full_width_ms(records, 2, FAMILY_STEPS)]} (steps 2 on), at full "
        f"width median {float(np.median(ms)):.1f}; peak memory of the training "
        f"{renders.calls[-1].peak_before_gb:.2f} GB, of the whole run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; the command {total_s:.1f} s")
    return counts


def phase_host_store(tmp: pathlib.Path, card: str) -> list:
    """Phase 7c: Truck.py (FourierGrid, seven banks of ~319^3) through
    ``run_train`` on a NeRF++-layout capture with the rays in host memory
    (``load2gpu_on_the_fly``), its boundaries compressed so that the last
    steps run at full width. Returns [the launch counts of the run]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.train import step as step_mod

    t0 = time.time()
    data = synthetic.orbit_scene(TRUCK_VIEWS, TRUCK_H, TRUCK_W, seed=3, n_test=TRUCK_TEST,
                                 cam_radius=CAM_RADIUS, sphere_radius=SPHERE_RADIUS)
    scene = synthetic.write_nerfpp_scene(str(tmp / "tat_training_Truck_store"), data)
    cfg_file = write_config(tmp / "truck_store.py", TRUCK_HOST_CONFIG, scene, tmp / "logs",
                            FAMILY_STEPS)
    cfg = loader.load_config(cfg_file)
    data = common.load_everything(cfg)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    full = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    banks = 2 * full.fourier_freq_num + 1
    if not cfg.data.load2gpu_on_the_fly:
        raise AssertionError("Truck.py does not ask for the host store")
    log(f"[7c] config {TRUCK_HOST_CONFIG.relative_to(ROOT)}: {banks} banks of "
        f"{full.world_size_rgb}, k0 {full.k0_dim} channels {full.grid_dtype} "
        f"({banks * np.prod(full.world_size_rgb) * (full.k0_dim + 1) / 1e9:.2f} G grid "
        f"elements), N_rand {ft.N_rand}, load2gpu_on_the_fly, pg_scale {ft.pg_scale}; scene of "
        f"{TRUCK_VIEWS} + {TRUCK_TEST} views of {TRUCK_H}x{TRUCK_W} made, written and loaded "
        f"in {time.time() - t0:.1f} s")
    stamps, peaks = [], []

    def callback(step, metrics):
        if not np.isfinite(float(metrics["loss"])):  # synchronises the step
            raise AssertionError(f"[7c] step {step}: loss {float(metrics['loss'])}")
        stamps.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_start = time.perf_counter()
    with Spy(step_mod.HostRayStoreSampler, "next_batch") as batches, \
            Spy(step_mod.FlattenSampler, "next_batch") as device_batches:
        _, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cuda", log_fn=log,
                                            log_every=1, callback=callback)
    counts = dict(build.LAUNCHES)
    want = {k: v * FAMILY_STEPS for k, v in TRAIN_PER_STEP.items()}
    want["masked_adam"] = adam_wanted("[7c]", FAMILY_STEPS)
    if counts != want:
        raise AssertionError(f"[7c] launch counts {counts} != {want}")
    if len(batches.calls) != FAMILY_STEPS or device_batches.calls:
        raise AssertionError(f"[7c] {len(batches.calls)} host batches, "
                             f"{len(device_batches.calls)} from a device store")
    want_shape = (banks, *full.world_size_rgb, full.k0_dim)
    if tuple(params.k0.grid.shape) != want_shape or params.k0.grid.dtype != torch.bfloat16:
        raise AssertionError(f"[7c] k0 grid {tuple(params.k0.grid.shape)}, want {want_shape}")
    dts = np.diff([t_start] + stamps) * 1e3
    first = CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS
    step_ms = float(np.median(dts[first - 1:]))
    batch_ms = float(np.median([c.seconds for c in batches.calls][first - 1:])) * 1e3
    peak = max(peaks)
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"[7c] Truck.py on {card}: grids {want_shape} bf16 from step {CLI_PG_SCALE[-1]}; "
        f"ms/step {[round(float(t), 1) for t in dts]}, at full width (steps {first} to "
        f"{FAMILY_STEPS}) median {step_ms:.1f}; the host batch (gather into the pinned stage and "
        f"the copy's launch) {batch_ms:.2f} ms, {100 * batch_ms / step_ms:.2f}% of a step; peak "
        f"memory by step {[round(x, 2) for x in peaks]} GB, the most {peak:.2f} GB of the "
        f"card's {card_gb:.1f} GB; launches {counts}")
    if peak >= card_gb:
        raise AssertionError(f"[7c] peak {peak} GB")
    return [counts]


# ---------------------------------------------------------------------------
# the Waymo and free-trajectory layouts (phase 8)


def cut_trajectory(call) -> None:
    """A spy's ``after`` for ``load_everything``: the test split of a waymo
    capture cut to its val views and the first ``WAYMO_TRAJECTORY`` of the
    200 trajectory views (which have no images)."""
    import numpy as np

    d = call.result
    d["i_test"] = np.concatenate([d["i_val"], d["i_test"][:WAYMO_TRAJECTORY]])


def phase_cli_waymo(tmp: pathlib.Path, card: str) -> list:
    """Phase 8a: waymo_no_block.py's command-line train, ``--diffuse`` on, on
    a Waymo-layout capture, without its checkpoint (``cli_train_in_memory``:
    the disk is kept for phase 13a, which saves this config's width), then
    the render of its val views (with PSNR) and of trajectory views
    (without). Returns the launch counts of the run."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    t0 = time.time()
    kw = dict(seed=4, cam_radius=CAM_RADIUS, sphere_radius=SPHERE_RADIUS)
    a = synthetic.orbit_scene(WAYMO_TRAIN + WAYMO_VAL, WAYMO_H, WAYMO_W, **kw)
    b = synthetic.orbit_scene(WAYMO_OTHER, WAYMO_H, WAYMO_W, focal_scale=0.9, **kw)
    views = {k: np.concatenate([a[k][:WAYMO_TRAIN], b[k], a[k][WAYMO_TRAIN:]])
             for k in ("images", "poses", "Ks")}
    cams = [73] * WAYMO_TRAIN + [74] * WAYMO_OTHER + [73] * WAYMO_VAL
    scene = synthetic.write_waymo_scene(str(tmp / "waymo_ordered_dataset"), views, cams,
                                        n_val=WAYMO_VAL,
                                        diffusion={"airplane": 1.0 - a["images"][0]})
    cfg_file = write_config(tmp / "waymo_cli.py", WAYMO_CONFIG, scene, tmp / "logs",
                            FAMILY_STEPS)
    cfg = loader.load_config(cfg_file)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    full = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    banks = 2 * full.fourier_freq_num + 1
    swap = dict(dict(cfg.diffusion).get("diff_replace", ()))
    log(f"[8a] config {WAYMO_CONFIG.relative_to(ROOT)}: {banks} banks of {full.world_size_rgb}, "
        f"k0 {full.k0_dim} channels {full.grid_dtype}, N_rand {ft.N_rand}, sample budget "
        f"{full.sample_budget}, colour budget {full.color_budget}, weight_freq {ft.weight_freq}, "
        f"weight_main {ft.weight_main}, pg_scale {ft.pg_scale}, --diffuse with {swap} (its "
        f"training_ids keep 73_<i> only); capture of {WAYMO_TRAIN} + {WAYMO_OTHER} training "
        f"views (cameras 73 and 74) and {WAYMO_VAL} val views of {WAYMO_H}x{WAYMO_W} made and "
        f"written in {time.time() - t0:.1f} s")
    own = loader.load_config(str(WAYMO_CONFIG)).fine_train
    log(f"[8a] cuts: {FAMILY_STEPS} steps of the config's {own.N_iters}; its boundaries "
        f"{list(own.pg_scale)} compressed to {list(CLI_PG_SCALE)}; {WAYMO_TRAIN + WAYMO_OTHER} "
        f"training and {WAYMO_VAL} val views; the render's test split cut to the val views "
        f"and {WAYMO_TRAJECTORY} of the 200 trajectory views")
    t0 = time.time()
    n_render = WAYMO_VAL + WAYMO_TRAJECTORY
    load, records, (_, _, params), render = cli_train_in_memory(
        "[8a]", cfg_file, ["--i_print", "1", "--diffuse"], load_after=cut_trajectory)
    total_s = time.time() - t0
    data = load.result
    if load.kwargs != {"sample_num": -1, "diffuse": True} or \
            len(data["i_train"]) != WAYMO_TRAIN or len(data["i_val"]) != WAYMO_VAL:
        raise AssertionError(f"[8a] load_everything {load.kwargs}: {len(data['i_train'])} "
                             f"training and {len(data['i_val'])} val views")
    counts = check_cli_run("[8a]", dict(build.LAUNCHES), render, FAMILY_STEPS, n_render,
                           (WAYMO_H, WAYMO_W))
    out = render.result["test"]
    if len(out["psnrs"]) != WAYMO_VAL or not np.isfinite(out["psnrs"]).all():
        raise AssertionError(f"[8a] PSNR of {len(out['psnrs'])} views, want the "
                             f"{WAYMO_VAL} val views only")
    records = check_family_records("[8a]", records, "FourierGrid", full.world_size_rgb)
    freq = [r["loss_freq"] for r in records if "loss" in r]
    if len(freq) != FAMILY_STEPS or not all(np.isfinite(f) and f > 0 for f in freq):
        raise AssertionError(f"[8a] the Fourier loss by step {freq}")
    want = (banks, *full.world_size_rgb, full.k0_dim)
    if tuple(params.k0.grid.shape) != want or params.k0.grid.dtype != torch.bfloat16:
        raise AssertionError(f"[8a] k0 grid {tuple(params.k0.grid.shape)}, want {want} bf16")
    ms = full_width_ms(records, CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS, FAMILY_STEPS)
    view_ms = [round(t * 1e3, 1) for t in out["seconds"]]
    log(f"[8a] waymo_no_block.py on {card}: load_everything {load.seconds:.2f} s; grids {want} "
        f"bf16 from step {CLI_PG_SCALE[-1]}; ms/step by the callback's clock "
        f"{[round(t, 1) for t in full_width_ms(records, 2, FAMILY_STEPS)]} (steps 2 on), at full "
        f"width median {float(np.median(ms)):.1f}; Fourier loss by step "
        f"{[round(f, 5) for f in freq]}; peak memory of the training "
        f"{render.peak_before_gb:.2f} GB, of the whole run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; render {view_ms} ms/view ("
        f"{WAYMO_VAL} val views with PSNR {[round(x, 3) for x in out['psnrs']]}, then "
        f"{WAYMO_TRAJECTORY} of the 200 trajectory views without); load, train and render "
        f"{total_s:.1f} s, no checkpoint")
    return counts


def phase_free(tmp: pathlib.Path, card: str) -> list:
    """Phase 8b: grass.py (seven banks of 319^3 in f32, every one of 1064
    samples a ray, no budget) on a free-trajectory capture loaded as the
    command line loads it, trained through ``run_train`` without a
    checkpoint (one with Adam's state would hold 35.4 GB, past what a run
    may write to the machine's disk beside the other phases; see the note
    at ``CLI_SAVE_EVERY``), then its test view
    rendered from the trained parameters as ``run_render`` renders it.
    Returns the launch counts of the training and of the render."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop

    t0 = time.time()
    data = synthetic.orbit_scene(FREE_VIEWS, FREE_H, FREE_W, seed=5, cam_radius=CAM_RADIUS,
                                 sphere_radius=SPHERE_RADIUS)
    scene = synthetic.write_free_scene(str(tmp / "free_dataset_grass"), data, factor=FREE_FACTOR)
    cfg_file = write_config(tmp / "free_cli.py", FREE_CONFIG, scene, tmp / "logs", FAMILY_STEPS)
    cfg = loader.load_config(cfg_file)
    t1 = time.time()
    data = common.load_everything(cfg)
    load_s = time.time() - t1
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    full = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    banks = 2 * full.fourier_freq_num + 1
    elements = banks * int(np.prod(full.world_size_rgb)) * (full.k0_dim + 1)
    log(f"[8b] config {FREE_CONFIG.relative_to(ROOT)}: {banks} banks of {full.world_size_rgb}, "
        f"k0 {full.k0_dim} channels {full.grid_dtype} ({elements / 1e9:.2f} G grid elements), "
        f"N_rand {ft.N_rand}, {2 * full.n_inner} samples a ray, sample budget "
        f"{full.sample_budget}, colour budget {full.color_budget}, pg_scale {ft.pg_scale}; "
        f"capture of {FREE_VIEWS} views stored at {FREE_FACTOR * FREE_H}x{FREE_FACTOR * FREE_W} "
        f"made and written in {t1 - t0:.1f} s, loaded by load_everything in {load_s:.2f} s "
        f"({len(data['i_train'])} training views, test views "
        f"{[int(i) for i in data['i_test']]})")
    own = loader.load_config(str(FREE_CONFIG)).fine_train
    log(f"[8b] cuts: {FAMILY_STEPS} steps of the config's {own.N_iters}; its boundaries "
        f"{list(own.pg_scale)} compressed to {list(CLI_PG_SCALE)}; {FREE_VIEWS} views; no "
        f"checkpoint; the render of the {len(data['i_test'])} test view through "
        "render_viewpoints")
    stamps, peaks = [], []

    def callback(step, metrics):
        if not np.isfinite(float(metrics["loss"])):  # synchronises the step
            raise AssertionError(f"[8b] step {step}: loss {float(metrics['loss'])}")
        stamps.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_start = time.perf_counter()
    family, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cuda", log_fn=log,
                                             log_every=1, callback=callback)
    counts = dict(build.LAUNCHES)
    want = {k: v * FAMILY_STEPS for k, v in TRAIN_PER_STEP.items()}
    want["masked_adam"] = adam_wanted("[8b]", FAMILY_STEPS)
    if counts != want:
        raise AssertionError(f"[8b] launch counts {counts} != {want}")
    want_shape = (banks, *full.world_size_rgb, full.k0_dim)
    if tuple(params.k0.grid.shape) != want_shape or params.k0.grid.dtype != torch.float32 or \
            mcfg.sample_budget != 0:
        raise AssertionError(f"[8b] k0 grid {tuple(params.k0.grid.shape)} "
                             f"{params.k0.grid.dtype}, want {want_shape} f32 without a budget")
    dts = np.diff([t_start] + stamps) * 1e3
    first = CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS
    step_ms = float(np.median(dts[first - 1:]))
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"[8b] grass.py on {card}: grids {want_shape} f32 from step {CLI_PG_SCALE[-1]}; ms/step "
        f"{[round(float(t), 1) for t in dts]}, at full width (steps {first} to {FAMILY_STEPS}) "
        f"median {step_ms:.1f}; peak memory by step {[round(x, 2) for x in peaks]} GB, the most "
        f"{max(peaks):.2f} GB of the card's {card_gb:.1f} GB; launches {counts}")
    if max(peaks) >= card_gb:
        raise AssertionError(f"[8b] peak {max(peaks)} GB")

    # ---- the test view, as run_render renders it: the family's render cache
    # (none: the packed table would pass the memory guard) and forward
    idx = np.asarray(data["i_test"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(build.LAUNCHES)
    out = render_held_out("[8b]", cfg, data, family, mcfg, params)
    render_counts = launches_since(before)
    n_chunks = len(idx) * -(-FREE_H * FREE_W // RENDER_CHUNK)
    if out["rgbs"].shape != (len(idx), FREE_H, FREE_W, 3) or not np.isfinite(out["rgbs"]).all() \
            or render_counts != {"march_forward": n_chunks}:
        raise AssertionError(f"[8b] rendered {out['rgbs'].shape}, launches {render_counts}")
    log(f"[8b] render of {len(idx)} test view of {FREE_H}x{FREE_W} on {card}: "
        f"{[round(t * 1e3, 1) for t in out['seconds']]} ms/view, psnr "
        f"{[round(x, 3) for x in out['psnrs']]}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {render_counts}")
    return [counts, render_counts]


# ---------------------------------------------------------------------------
# the DVGO family with its coarse stage (phase 9)


def stage_ms(exp_dir: str, stage: str, first: int, last: int) -> list:
    """ms of steps first..last of a stage by the loop's clock, from its own
    record (``<stage>_metrics.jsonl``)."""
    with open(os.path.join(exp_dir, f"{stage}_metrics.jsonl")) as f:
        steps = {r["step"]: r for r in map(json.loads, f) if "loss" in r}
    return [1e3 * (steps[k]["elapsed_s"] - steps[k - 1]["elapsed_s"])
            for k in range(first, last + 1)]


def dvgo_spies():
    """Spies on what phase 9 reports of the recipe: the voxel counts of
    ``pervoxel_lr``, the ``in_maskcache`` filter and the two boxes."""
    from unboundednerfpytorch_tpu_torch.models import dvgo
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
    from unboundednerfpytorch_tpu_torch.train import loop

    return (Spy(dvgo, "voxel_count_views"), Spy(loop, "filter_in_maskcache"),
            Spy(bbox_mod, "compute_bbox_by_cam_frustrm"),
            Spy(bbox_mod, "compute_bbox_by_coarse_geo"))


def report_dvgo_spies(tag: str, counts_spy, filter_spy, frustum_spy, coarse_spy) -> dict:
    """Log the seconds of ``voxel_count_views`` and of the ``in_maskcache``
    filter, the share of rays it kept, and the fine box against the
    frustum's; check that each ran once. Returns the fine box."""
    import numpy as np

    if len(counts_spy.calls) != 1 or len(filter_spy.calls) != 1 or len(coarse_spy.calls) != 1:
        raise AssertionError(f"{tag}: voxel_count_views {len(counts_spy.calls)}, in_maskcache "
                             f"{len(filter_spy.calls)}, coarse box {len(coarse_spy.calls)} calls")
    count = counts_spy.calls[0].result
    rep = filter_spy.calls[0].result[1]
    lo_c, hi_c = (np.asarray(x) for x in frustum_spy.calls[0].result)
    lo_f, hi_f = (np.asarray(x) for x in coarse_spy.calls[0].result)
    if not ((lo_c <= lo_f).all() and (hi_f <= hi_c).all() and (lo_f < hi_f).all()):
        raise AssertionError(f"{tag}: fine box {lo_f} .. {hi_f} outside {lo_c} .. {hi_c}")
    log(f"{tag} pervoxel_lr: voxel_count_views {counts_spy.calls[0].seconds:.2f} s for "
        f"{tuple(count.shape[:3])} voxels, {int((count > 2).sum())} seen by more than 2 views, "
        f"the most {int(count.max())}; in_maskcache filter {rep['seconds']:.2f} s, kept "
        f"{rep['kept']} of {rep['rays']} rays ({100 * rep['kept'] / rep['rays']:.1f}%); "
        f"frustum box {lo_c.round(4).tolist()} .. {hi_c.round(4).tolist()}, fine box from the "
        f"coarse geometry {lo_f.round(4).tolist()} .. {hi_f.round(4).tolist()} "
        f"({100 * float(np.prod(hi_f - lo_f) / np.prod(hi_c - lo_c)):.2f}% of its volume)")
    return {"box": (lo_f, hi_f), "kept": rep["kept"] / rep["rays"]}


def fine_world_size(fm, box) -> tuple:
    """The fine grid's world size at full width on ``box`` after its
    ``world_bound_scale``."""
    import numpy as np

    from unboundednerfpytorch_tpu_torch.models import dvgo

    lo, hi = (np.asarray(x, np.float64) for x in box)
    shift = (hi - lo) * (fm.world_bound_scale - 1) / 2
    return dvgo.config_from(fm, lo - shift, hi + shift, fm.num_voxels_rgb).world_size


def phase_cli_lego(cfg_file: str, card: str) -> list:
    """Phase 9a: nerf/lego.py (DVGO) through the command line: ``train`` (the
    coarse stage at 100^3 with ``pervoxel_lr`` and ``maskout_near_cam_vox``,
    then the fine stage on the coarse geometry's box and the
    ``in_maskcache`` rays, ending at full width), the render of the test
    views that follows, then ``--program export_coarse``. Returns the launch
    counts of the training and of the render."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    cfg = loader.load_config(cfg_file)
    cm, fm, ct, ft = (cfg.coarse_model_and_render, cfg.fine_model_and_render, cfg.coarse_train,
                      cfg.fine_train)
    own = loader.load_config(str(LEGO_CONFIG))
    log(f"[9a] config {LEGO_CONFIG.relative_to(ROOT)} (DVGO): coarse {cm.num_voxels_rgb} voxels, "
        f"k0 3 channels, no MLP, N_rand {ct.N_rand}, {ct.ray_sampler} sampler, pervoxel_lr "
        f"{ct.pervoxel_lr}, maskout_near_cam_vox {cm.maskout_near_cam_vox}; fine "
        f"{fm.num_voxels_rgb} voxels, k0 {fm.rgbnet_dim} channels, rgbnet "
        f"{fm.rgbnet_depth}x{fm.rgbnet_width}, N_rand {ft.N_rand}, {ft.ray_sampler} sampler; "
        f"cuts: {ct.N_iters} coarse steps of {own.coarse_train.N_iters}, {ft.N_iters} fine steps "
        f"of {own.fine_train.N_iters}, boundaries {list(own.fine_train.pg_scale)} compressed to "
        f"{list(ft.pg_scale)}; {LEGO_TRAIN} training views of the scene's 100")
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.utils import observability

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    spies = dvgo_spies()
    # the panel of the fine stage's last step (i_panel): the first
    # render_image of the command, then its PNG and record
    with render_spy() as renders, spies[0], spies[1], spies[2], spies[3], \
            Spy(renderer, "render_image") as images, \
            Spy(observability, "record_panel") as panels:
        run_cli(["--config", cfg_file, "--i_print", "1", "--render_test"])
    total_s = time.time() - t0
    found = report_dvgo_spies("[9a]", *spies)
    render = renders.calls[-1]
    out = render.result["test"]
    n_test = LEGO_HELD
    if out["rgbs"].shape[:3] != (n_test, LEGO_H, LEGO_W) or not np.isfinite(out["rgbs"]).all():
        raise AssertionError(f"[9a] rendered {out['rgbs'].shape} or non-finite values")
    steps = ct.N_iters + ft.N_iters
    chunks = -(-LEGO_H * LEGO_W // RENDER_CHUNK)
    train = train_counts_of(dict(build.LAUNCHES), render.launches)
    want = {"march_forward": steps + chunks, "march_backward": steps,  # the panel's view
            "masked_adam": adam_wanted("[9a]", ft.N_iters),
            "masked_adam_per_lr": ADAM_WANTED.n_lr}
    want_render = {"march_forward": n_test * chunks}
    if len(panels.calls) != 1 or len(images.calls) != 1 + n_test:
        raise AssertionError(f"[9a] {len(panels.calls)} panels, {len(images.calls)} views "
                             f"rendered (want 1 and 1 + {n_test})")
    SHARED["9a"] = {"rgbs": out["rgbs"], "panel": panels.calls[0].result,
                    "panel_ms": (images.calls[0].seconds + panels.calls[0].seconds) * 1e3}
    if train != want or render.launches != want_render or ADAM_WANTED.n_lr != ct.N_iters:
        raise AssertionError(f"[9a] launches train {train} (want {want}), render "
                             f"{render.launches} (want {want_render})")
    # the coarse stage found the seeded sphere: its last PSNR, and a fine box
    # around the sphere (radius SPHERE_RADIUS at the origin), floaters allowed
    with open(os.path.join(exp_dir, "coarse_metrics.jsonl")) as f:
        psnr = {r["step"]: r["psnr"] for r in map(json.loads, f) if "psnr" in r}
    log(f"[9a] coarse PSNR by step "
        f"{[(k, round(psnr[k], 2)) for k in sorted(psnr) if k % 100 == 0]}")
    lo, hi = found["box"]
    if psnr[ct.N_iters] < LEGO_COARSE_MIN_PSNR or not (
            (0.5 * SPHERE_RADIUS <= -lo).all() and (-lo <= 1.5 * SPHERE_RADIUS).all()
            and (0.5 * SPHERE_RADIUS <= hi).all() and (hi <= 1.5 * SPHERE_RADIUS).all()) or \
            not 0 < found["kept"] < 1:
        raise AssertionError(f"[9a] the coarse stage did not find the sphere: PSNR "
                             f"{psnr[ct.N_iters]:.2f}, fine box {lo} .. {hi}, in_maskcache "
                             f"kept {found['kept']:.3f}")
    ws = fine_world_size(fm, found["box"])
    meta = json.load(open(os.path.join(exp_dir, "fine_last", "meta.json")))
    with open(os.path.join(exp_dir, "fine_metrics.jsonl")) as f:
        bounds = [r["pg_scale"] for r in map(json.loads, f) if "pg_scale" in r]
    if tuple(bounds[-1]["world_size_rgb"]) != tuple(ws) or meta["global_step"] != ft.N_iters:
        raise AssertionError(f"[9a] fine grids {bounds[-1]['world_size_rgb']} at the last "
                             f"boundary, want {ws}; fine_last at step {meta['global_step']}")
    coarse_ms = stage_ms(exp_dir, "coarse", 3, ct.N_iters)
    first = ft.pg_scale[-1] + 1 + WARMUP_STEPS
    fine_ms = stage_ms(exp_dir, "fine", first, ft.N_iters)
    log(f"[9a] lego.py on {card}: coarse ms/step (steps 3 to {ct.N_iters}) median "
        f"{float(np.median(coarse_ms)):.2f}, min {min(coarse_ms):.2f}; fine grids {tuple(ws)} "
        f"from step {ft.pg_scale[-1]}, ms/step "
        f"{[round(t, 1) for t in stage_ms(exp_dir, 'fine', 2, ft.N_iters)]} (steps 2 on), at "
        f"full width (steps {first} on) median {float(np.median(fine_ms)):.1f}; "
        f"peak memory of the training {render.peak_before_gb:.2f} GB, of the whole run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; render "
        f"{[round(t * 1e3, 1) for t in out['seconds']]} ms/view, psnr "
        f"{[round(x, 3) for x in out['psnrs']]}; launches train {train}, render "
        f"{render.launches}; the command {total_s:.1f} s")
    log(f"[9a] held-out panel (phase 11e) of the first test view at fine step "
        f"{ft.N_iters}: {SHARED['9a']['panel_ms']:.1f} ms (its render "
        f"{images.calls[0].seconds * 1e3:.1f} ms), psnr {SHARED['9a']['panel']:.3f}")
    # the coarse volume, as a user exports it
    before = dict(build.LAUNCHES)
    t0 = time.time()
    run_cli(["--config", cfg_file, "--program", "export_coarse"])
    coarse = json.load(open(os.path.join(exp_dir, "coarse_last", "meta.json")))
    with np.load(os.path.join(exp_dir, "coarse_volume.npz")) as vol:
        alpha, rgb = vol["alpha"], vol["rgb"]
    from unboundednerfpytorch_tpu_torch.models import dvgo

    cws = dvgo.DVGOConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in coarse["model_kwargs"].items()}).world_size
    if alpha.shape != tuple(cws) or rgb.shape != (*cws, 3) or not np.isfinite(alpha).all() \
            or launches_since(before) or coarse["global_step"] != ct.N_iters:
        raise AssertionError(f"[9a] export_coarse: alpha {alpha.shape}, rgb {rgb.shape}, want "
                             f"{cws}; launches {launches_since(before)}")
    log(f"[9a] export_coarse {time.time() - t0:.1f} s: alpha {alpha.shape} (max "
        f"{float(alpha.max()):.4f}, {int((alpha > cm.bbox_thres).sum())} voxels above "
        f"bbox_thres {fm.bbox_thres}), rgb {rgb.shape}")
    return [train, render.launches]


def phase_truck_lg(tmp: pathlib.Path, card: str) -> list:
    """Phase 9b: tankstemple/Truck_lg.py (DVGO, the host ray store,
    ``pervoxel_lr_downrate`` 2, a fine grid of 256^3) through ``run_train``
    without a checkpoint on a Tanks & Temples capture. Returns [the launch
    counts of the run]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.train import step as step_mod

    t0 = time.time()
    data = synthetic.orbit_scene(TRUCK_LG_VIEWS, TRUCK_LG_H, TRUCK_LG_W, seed=7,
                                 n_test=TRUCK_LG_TEST, cam_radius=CAM_RADIUS,
                                 sphere_radius=SPHERE_RADIUS)
    scene = synthetic.write_tankstemple_scene(str(tmp / "TanksAndTemple_Truck_lg"), data)
    cfg_file = tmp / "truck_lg.py"
    cfg_file.write_text(
        f"_base_ = {str(TRUCK_LG_CONFIG)!r}\nbasedir = {str(tmp / 'logs')!r}\n"
        f"data = dict(datadir={scene!r})\n"
        f"coarse_train = dict(N_iters={TRUCK_LG_COARSE_STEPS})\n"
        f"fine_train = dict(N_iters={TRUCK_LG_FINE_STEPS}, pg_scale={list(TRUCK_LG_PG_SCALE)}, "
        f"decay_after_scale={TRUCK_LG_DECAY})\n")
    cfg = loader.load_config(str(cfg_file))
    data = common.load_everything(cfg)
    ct, ft, fm = cfg.coarse_train, cfg.fine_train, cfg.fine_model_and_render
    own = loader.load_config(str(TRUCK_LG_CONFIG))
    if not cfg.data.load2gpu_on_the_fly or ct.pervoxel_lr_downrate != 2:
        raise AssertionError("Truck_lg.py does not ask for the host store and downrate 2")
    log(f"[9b] config {TRUCK_LG_CONFIG.relative_to(ROOT)} (DVGO, load2gpu_on_the_fly, "
        f"pervoxel_lr_downrate {ct.pervoxel_lr_downrate}, fine {fm.num_voxels_rgb} voxels, k0 "
        f"{fm.rgbnet_dim} channels, rgbnet {fm.rgbnet_depth}x{fm.rgbnet_width}, N_rand "
        f"{ft.N_rand}); cuts: {ct.N_iters} coarse steps of {own.coarse_train.N_iters}, "
        f"{ft.N_iters} fine steps of {own.fine_train.N_iters}, boundaries "
        f"{list(own.fine_train.pg_scale)} compressed to {list(ft.pg_scale)}, decay_after_scale "
        f"{own.fine_train.decay_after_scale} -> {ft.decay_after_scale}, no checkpoint; "
        f"capture of {TRUCK_LG_VIEWS} + {TRUCK_LG_TEST} views of {TRUCK_LG_H}x{TRUCK_LG_W} "
        f"made, written and loaded in {time.time() - t0:.1f} s")
    stamps, psnr, bounds = [], [], []

    def callback(step, metrics):
        if not np.isfinite(float(metrics["loss"])):  # synchronises the step
            raise AssertionError(f"[9b] step {step}: loss {float(metrics['loss'])}")
        stamps.append((step, time.perf_counter(), torch.cuda.max_memory_allocated() / 1e9))
        psnr.append(float(metrics["psnr"]))
        bounds.append(metrics.get("pg_scale"))
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spies = dvgo_spies()
    t_start = time.perf_counter()
    with Spy(step_mod.HostRayStoreSampler, "next_batch", keep=False) as batches, \
            spies[0], spies[1], spies[2], spies[3]:
        _, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cuda", log_fn=log,
                                            log_every=1, callback=callback)
    counts = dict(build.LAUNCHES)
    steps = ct.N_iters + ft.N_iters
    want = {"march_forward": steps, "march_backward": steps,
            "masked_adam": adam_wanted("[9b]", ft.N_iters), "masked_adam_per_lr": ct.N_iters}
    if counts != want or ADAM_WANTED.n_lr != ct.N_iters or len(stamps) != steps:
        raise AssertionError(f"[9b] launch counts {counts} != {want}, {len(stamps)} steps")
    found = report_dvgo_spies("[9b]", *spies)
    by_step = [(k, round(psnr[k - 1], 2)) for k in range(100, ct.N_iters + 1, 100)]
    log(f"[9b] coarse PSNR by step {by_step}, fine {[round(x, 2) for x in psnr[ct.N_iters:]]}")
    # the fine stage has live samples at full width: the coarse stage found
    # geometry (the fine box under half the frustum box), the filter kept
    # rays, and the occupancy cache holds voxels after the last boundary
    lo_c, hi_c = (np.asarray(x) for x in spies[2].calls[0].result)
    share = float(np.prod(found["box"][1] - found["box"][0]) / np.prod(hi_c - lo_c))
    last = [b for b in bounds if b is not None][-1]
    if not (share < 0.5 and found["kept"] > 0 and last["occupancy"] > 0):
        raise AssertionError(f"[9b] no live sample at full width: fine box {share:.3f} of the "
                             f"frustum box, in_maskcache kept {found['kept']:.3f} of the rays, "
                             f"occupancy {last['occupancy']:.4f} after step {last['step']}")
    log(f"[9b] occupancy cache after each fine boundary "
        f"{[(b['step'], round(b['occupancy'], 4)) for b in bounds if b is not None]}")
    ws = fine_world_size(fm, found["box"])
    if tuple(params.k0.grid.shape) != (1, *ws, fm.rgbnet_dim):
        raise AssertionError(f"[9b] k0 grid {tuple(params.k0.grid.shape)}, want {ws}")
    dts = np.diff([t_start] + [t for _, t, _ in stamps]) * 1e3
    peaks = [p for _, _, p in stamps]
    coarse_ms = dts[2:ct.N_iters]
    first = ft.pg_scale[-1] + 1 + WARMUP_STEPS
    fine_ms = dts[ct.N_iters + first - 1:]
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"[9b] Truck_lg.py on {card}: coarse ms/step (steps 3 on) median "
        f"{float(np.median(coarse_ms)):.2f}; fine grids {(1, *ws, fm.rgbnet_dim)} f32 from step "
        f"{ft.pg_scale[-1]}, ms/step {[round(float(t), 1) for t in dts[ct.N_iters:]]} (the first "
        f"with the stage's set-up: box, seed, ray store, filter), at full "
        f"width (steps {first} on) median {float(np.median(fine_ms)):.1f}; peak memory of the "
        f"coarse stage {max(peaks[:ct.N_iters]):.2f} GB, of the fine stage by step "
        f"{[round(x, 2) for x in peaks[ct.N_iters:]]} GB, the most {max(peaks):.2f} GB of the "
        f"card's {card_gb:.1f} GB; launches {counts}")
    if max(peaks) >= card_gb:
        raise AssertionError(f"[9b] peak {max(peaks)} GB")
    return [counts]


# ---------------------------------------------------------------------------
# the LINEMOD, CO3D, TensoRF and DMPIGO-coarse paths and the pose tuner
# (phase 10)


def stage_records(exp_dir: str, stage: str) -> list:
    with open(os.path.join(exp_dir, f"{stage}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def live_samples(tag: str, frustum_spy, coarse_spy, bounds: list, kept=None,
                 smaller: bool = True) -> float:
    """Fail unless the fine stage had live samples at full width: the fine box
    inside the frustum box (and, with ``smaller``, smaller than it: the
    coarse stage found geometry), the occupancy cache not empty after the
    last boundary (and, where a filter ran, some rays kept). Returns the
    fine box's share of the frustum box's volume."""
    import numpy as np

    lo_c, hi_c = (np.asarray(x) for x in frustum_spy.calls[0].result)
    lo_f, hi_f = (np.asarray(x) for x in coarse_spy.calls[0].result)
    share = float(np.prod(hi_f - lo_f) / np.prod(hi_c - lo_c))
    last = bounds[-1]
    if not ((lo_c <= lo_f).all() and (hi_f <= hi_c).all() and (share < 1.0 or not smaller)
            and last["occupancy"] > 0 and (kept is None or kept > 0)):
        raise AssertionError(f"{tag}: no live sample at full width: fine box {lo_f} .. {hi_f} "
                             f"in {lo_c} .. {hi_c} ({share:.4f} of it), occupancy "
                             f"{last['occupancy']:.4f} after step {last['step']}, kept {kept}")
    log(f"{tag} frustum box {lo_c.round(4).tolist()} .. {hi_c.round(4).tolist()}, fine box "
        f"{lo_f.round(4).tolist()} .. {hi_f.round(4).tolist()} ({100 * share:.2f}% of its "
        f"volume); occupancy cache after each fine boundary "
        f"{[(b['step'], round(b['occupancy'], 4)) for b in bounds]}")
    return share


def compressed(base: pathlib.Path, tmp: pathlib.Path, name: str, data: str, **stages) -> str:
    """A config over ``base`` with the capture, the log directory and each
    stage's cuts (a dict a stage)."""
    path = tmp / f"{name}.py"
    lines = [f"_base_ = {str(base)!r}", f"basedir = {str(tmp / 'logs')!r}", f"data = {data}"]
    lines += [f"{k} = dict({', '.join(f'{a}={v!r}' for a, v in kw.items())})"
              for k, kw in stages.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def phase_cli_linemod(tmp: pathlib.Path, card: str, paths: dict) -> list:
    """Phase 10a: linemod/ape.py through the command line on a seeded LINEMOD
    sequence (``LM_FRAMES`` frames of 640x480 JPEG, cropped to the config's
    90x90 around the object): ``train`` (the fine-only DVGO at 160^3 on the
    host ray store, ``in_maskcache``, its four boundaries compressed to
    ``LM_PG_SCALE``), the render of the test views, then ``--program
    linemod_eval`` in its sanity mode (every metric 1.0) and with seeded
    perturbed predictions (the scores fall). Its kernels' shapes go into
    ``paths``. Returns [train counts, render counts]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    t0 = time.time()
    synthetic.write_linemod_scene(str(tmp / "linemod"), "ape", LM_FRAMES, LM_TEST, seed=8)
    cfg_file = compressed(LINEMOD_CONFIG, tmp, "ape_cli", f"dict(datadir={str(tmp / 'linemod')!r})",
                          fine_train=dict(N_iters=LM_STEPS, pg_scale=list(LM_PG_SCALE)))
    cfg = loader.load_config(cfg_file)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    own = loader.load_config(str(LINEMOD_CONFIG))
    log(f"[10a] config {LINEMOD_CONFIG.relative_to(ROOT)} (DVGO, fine stage only, "
        f"load2gpu_on_the_fly {cfg.data.load2gpu_on_the_fly}, {ft.ray_sampler} sampler, crop "
        f"{cfg.data.width_max}x{cfg.data.height_max}, {fm.num_voxels_rgb} voxels, k0 "
        f"{fm.rgbnet_dim} channels, N_rand {ft.N_rand}); cuts: {ft.N_iters} steps of "
        f"{own.fine_train.N_iters}, boundaries {list(own.fine_train.pg_scale)} compressed to "
        f"{list(ft.pg_scale)}; a sequence of {LM_FRAMES} frames ({LM_TEST} test) written in "
        f"{time.time() - t0:.1f} s")
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with render_spy() as renders, Spy(common, "load_everything") as loads, \
            PathShapes() as paths["10a ape.py"]:
        run_cli(["--config", cfg_file, "--i_print", "1", "--render_test"])
    total_s = time.time() - t0
    data = loads.calls[0].result
    n_test = len(data["i_test"])
    counts = check_cli_run("[10a]", dict(build.LAUNCHES), renders.calls[-1], ft.N_iters, n_test,
                           tuple(int(v) for v in data["HW"][0]),
                           per_step={"march_forward": 1, "march_backward": 1})
    records = stage_records(exp_dir, "fine")
    bounds = [r["pg_scale"] for r in records if "pg_scale" in r]
    first = ft.pg_scale[-1] + 1 + WARMUP_STEPS
    ms = stage_ms(exp_dir, "fine", first, ft.N_iters)
    all_ms = [round(t, 1) for t in stage_ms(exp_dir, "fine", 2, ft.N_iters)]
    log(f"[10a] ape.py on {card}: scene load {loads.calls[0].seconds:.2f} s "
        f"({len(data['i_train'])} training views of {tuple(int(v) for v in data['HW'][0])}, "
        f"near {data['near']:.3f}, far {data['far']:.3f}); grids "
        f"{tuple(bounds[-1]['world_size_rgb'])} from step {ft.pg_scale[-1]}, ms/step {all_ms}"
        f" (steps 2 on), at full width median {float(np.median(ms)):.1f}; occupancy after "
        f"the last boundary {bounds[-1]['occupancy']:.4f}; peak memory of the training "
        f"{renders.calls[-1].peak_before_gb:.2f} GB; the command {total_s:.1f} s")
    # linemod_eval: the ground truth against itself, then perturbed predictions
    lines = run_cli(["--config", cfg_file, "--program", "linemod_eval"])
    gt = json.loads(lines[-1])
    if any(gt[k] != 1.0 for k in ("proj2d", "add", "add2", "add5", "cmd5")):
        raise AssertionError(f"[10a] linemod_eval in its sanity mode: {gt}")
    rng = np.random.default_rng(9)
    preds = np.asarray(data["object_poses"])[np.asarray(data["i_test"])].copy()
    preds[:, :, 3] += rng.normal(0.0, 0.02, preds[:, :, 3].shape)
    np.save(tmp / "ape_preds.npy", preds)
    bad = json.loads(run_cli(["--config", cfg_file, "--program", "linemod_eval",
                              "--pose_preds", str(tmp / "ape_preds.npy")])[-1])
    if not (bad["add"] < 1.0 and bad["cmd5"] < 1.0):
        raise AssertionError(f"[10a] linemod_eval on perturbed poses: {bad}")
    log(f"[10a] linemod_eval: ground truth {gt}; predictions 2 cm off (seeded) {bad}")
    return counts


def phase_co3d(tmp: pathlib.Path, card: str, paths: dict) -> list:
    """Phase 10b: co3d/teddybear.py through the command line on a seeded CO3D
    capture (``CO3D_FRAMES`` frames of ``CO3D_H`` x ``CO3D_W``, one test frame):
    the coarse stage (``CO3D_COARSE_STEPS`` steps: the geometry forms after
    500-900 from ``alpha_init`` 1e-6, as 9a found), then the fine stage to
    160^3 and the render of the test view. Fails unless the fine stage has
    live samples. Returns [train counts, render counts]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    t0 = time.time()
    scene = synthetic.write_co3d_scene(str(tmp / "co3d_teddybear"), n_frames=CO3D_FRAMES,
                                       n_test=CO3D_TEST, H=CO3D_H, W=CO3D_W, seed=10)
    cfg_file = compressed(
        CO3D_CONFIG, tmp, "teddybear_cli",
        "dict(" + ", ".join(f"{k}={scene[k]!r}" for k in ("datadir", "annot_path",
                                                          "split_path")) + ")",
        coarse_train=dict(N_iters=CO3D_COARSE_STEPS),
        fine_train=dict(N_iters=CO3D_FINE_STEPS, pg_scale=list(CO3D_PG_SCALE),
                        decay_after_scale=COMPRESSED_DECAY))
    cfg = loader.load_config(cfg_file)
    ct, ft, fm = cfg.coarse_train, cfg.fine_train, cfg.fine_model_and_render
    own = loader.load_config(str(CO3D_CONFIG))
    log(f"[10b] config {CO3D_CONFIG.relative_to(ROOT)} (DVGO, inverse_y, flip_x, flip_y; coarse "
        f"{cfg.coarse_model_and_render.num_voxels_rgb} voxels, pervoxel_lr {ct.pervoxel_lr}; "
        f"fine {fm.num_voxels_rgb} voxels, {ft.ray_sampler}); cuts: {ct.N_iters} coarse steps "
        f"of {own.coarse_train.N_iters}, {ft.N_iters} fine steps of {own.fine_train.N_iters}, "
        f"boundaries {list(own.fine_train.pg_scale)} compressed to {list(ft.pg_scale)}, "
        f"decay_after_scale {own.fine_train.decay_after_scale} -> {ft.decay_after_scale}; "
        f"{CO3D_FRAMES} frames of {CO3D_H}x{CO3D_W} and one with an empty mask written in "
        f"{time.time() - t0:.1f} s")
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spies = dvgo_spies()
    t0 = time.time()
    with render_spy() as renders, Spy(common, "load_everything") as loads, \
            spies[0], spies[1], spies[2], spies[3], PathShapes() as paths["10b teddybear.py"]:
        run_cli(["--config", cfg_file, "--i_print", "1", "--render_test"])
    total_s = time.time() - t0
    found = report_dvgo_spies("[10b]", *spies)
    data = loads.calls[0].result
    render = renders.calls[-1]
    out = render.result["test"]
    steps = ct.N_iters + ft.N_iters
    train = train_counts_of(dict(build.LAUNCHES), render.launches)
    want = {"march_forward": steps, "march_backward": steps,
            "masked_adam": adam_wanted("[10b]", ft.N_iters),
            "masked_adam_per_lr": ADAM_WANTED.n_lr}
    want_render = {"march_forward": CO3D_TEST * -(-CO3D_H * CO3D_W // RENDER_CHUNK)}
    if train != want or render.launches != want_render or ADAM_WANTED.n_lr != ct.N_iters \
            or out["rgbs"].shape[:3] != (CO3D_TEST, CO3D_H, CO3D_W) \
            or not np.isfinite(out["rgbs"]).all():
        raise AssertionError(f"[10b] launches train {train} (want {want}), render "
                             f"{render.launches} (want {want_render}), rgbs {out['rgbs'].shape}")
    bounds = [r["pg_scale"] for r in stage_records(exp_dir, "fine") if "pg_scale" in r]
    live_samples("[10b]", spies[2], spies[3], bounds, kept=found["kept"])
    psnr = {r["step"]: r["psnr"] for r in stage_records(exp_dir, "coarse") if "psnr" in r}
    first = ft.pg_scale[-1] + 1 + WARMUP_STEPS
    ms = stage_ms(exp_dir, "fine", first, ft.N_iters)
    log(f"[10b] teddybear.py on {card}: scene load {loads.calls[0].seconds:.2f} s "
        f"({len(data['i_train'])} training views); coarse PSNR by step "
        f"{[(k, round(psnr[k], 2)) for k in sorted(psnr) if k % 200 == 0]}; coarse ms/step "
        f"median {float(np.median(stage_ms(exp_dir, 'coarse', 3, ct.N_iters))):.2f}; fine grids "
        f"{tuple(bounds[-1]['world_size_rgb'])}, ms/step at full width median "
        f"{float(np.median(ms)):.1f}; peak memory of the training {render.peak_before_gb:.2f} "
        f"GB; render {[round(t * 1e3, 1) for t in out['seconds']]} ms/view, psnr "
        f"{[round(x, 3) for x in out['psnrs']]}; launches train {train}, render "
        f"{render.launches}; the command {total_s:.1f} s")
    return [train, render.launches]


def phase_ship(tmp: pathlib.Path, card: str, lego_file: str, paths: dict) -> list:
    """Phase 10c: nerf/ship.tensorf.py through ``run_train`` on 9a's
    NeRF-synthetic capture, from a copy of 9a's ``coarse_last`` (the resume
    finds the coarse stage finished and trains nothing there): the TensoRF
    fine stage (density n_comp 8, k0 n_comp 24 projected to 12 channels) on
    the coarse geometry's box, its six boundaries compressed to
    ``SHIP_PG_SCALE``, ending at 384^3; then one test view, rendered without
    a cache as ``run_render`` renders a TensoRF model. Fails unless the fine
    stage has live samples. Returns [train counts, render counts]."""
    import shutil

    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common
    from unboundednerfpytorch_tpu_torch.fields.grids import TensoRFGrid
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.train import loop

    lego = loader.load_config(lego_file)
    cfg_file = compressed(SHIP_CONFIG, tmp, "ship_tensorf", f"dict(datadir={lego.data.datadir!r})",
                          coarse_train=dict(N_iters=lego.coarse_train.N_iters),
                          fine_train=dict(N_iters=SHIP_FINE_STEPS, pg_scale=list(SHIP_PG_SCALE),
                                          decay_after_scale=COMPRESSED_DECAY))
    cfg = loader.load_config(cfg_file)
    ft, fm = cfg.fine_train, cfg.fine_model_and_render
    own = loader.load_config(str(SHIP_CONFIG))
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(exp_dir, exist_ok=True)
    shutil.copytree(os.path.join(lego.basedir, lego.expname, "coarse_last"),
                    os.path.join(exp_dir, "coarse_last"))
    t0 = time.time()
    data = common.load_everything(cfg)
    load_s = time.time() - t0
    log(f"[10c] config {SHIP_CONFIG.relative_to(ROOT)} (DVGO, {fm.density_type} "
        f"{dict(fm.density_config)} density, {fm.k0_type} {dict(fm.k0_config)} k0 of "
        f"{fm.rgbnet_dim} channels, {fm.num_voxels_rgb} voxels, N_rand {ft.N_rand}); from 9a's "
        f"coarse_last (step {lego.coarse_train.N_iters}); cuts: {ft.N_iters} fine steps of "
        f"{own.fine_train.N_iters}, boundaries {list(own.fine_train.pg_scale)} compressed to "
        f"{list(ft.pg_scale)}, decay_after_scale {own.fine_train.decay_after_scale} -> "
        f"{ft.decay_after_scale}; 9a's capture loaded in {load_s:.2f} s")
    stamps, bounds = [], []

    def callback(step, metrics):
        if not np.isfinite(float(metrics["loss"])):  # synchronises the step
            raise AssertionError(f"[10c] step {step}: loss {float(metrics['loss'])}")
        stamps.append((time.perf_counter(), torch.cuda.max_memory_allocated() / 1e9))
        torch.cuda.reset_peak_memory_stats()
        if "pg_scale" in metrics:
            bounds.append(metrics["pg_scale"])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spies = dvgo_spies()
    t_start = time.perf_counter()
    shapes = paths["10c ship.tensorf.py"] = PathShapes()
    with spies[1], spies[2], spies[3], shapes:
        family, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cuda", log_fn=log,
                                                 log_every=1, callback=callback,
                                                 exp_dir=exp_dir)
    counts = dict(build.LAUNCHES)
    want = {"march_forward": ft.N_iters, "march_backward": ft.N_iters,
            "masked_adam": adam_wanted("[10c]", ft.N_iters)}
    if counts != want or len(stamps) != ft.N_iters:
        raise AssertionError(f"[10c] launch counts {counts} != {want}, {len(stamps)} steps "
                             "(the coarse stage must train nothing)")
    if not (isinstance(params.k0, TensoRFGrid) and isinstance(params.density, TensoRFGrid)):
        raise AssertionError(f"[10c] fields {type(params.density)}, {type(params.k0)}")
    rep = spies[1].calls[0].result[1]
    live_samples("[10c]", spies[2], spies[3], bounds, kept=rep["kept"])
    dts = np.diff([t_start] + [t for t, _ in stamps]) * 1e3
    peaks = [p for _, p in stamps]
    first = ft.pg_scale[-1] + 1 + WARMUP_STEPS
    n_samples = loop.FAMILIES[family].n_samples(mcfg, fm.stepsize)
    log(f"[10c] ship.tensorf.py on {card}: fields at {mcfg.world_size} ({n_samples} samples a "
        f"ray) from step {ft.pg_scale[-1]}; ms/step {[round(float(t), 1) for t in dts]} (the "
        f"first with the stage's set-up), at full width median "
        f"{float(np.median(dts[first - 1:])):.1f}; peak memory by step "
        f"{[round(x, 2) for x in peaks]} GB; in_maskcache kept {rep['kept']} of {rep['rays']} "
        f"rays; launches {counts}")
    # one test view, uncached (a TensoRF model has no render cache)
    params.requires_grad_(False)
    if loop.FAMILIES[family].build_render_cache(params, mcfg) is not None:
        raise AssertionError("[10c] a TensoRF model got a render cache")
    fwd_core = loop.make_forward(mcfg, {"near": float(data["near"]), "far": float(data["far"]),
                                        "bg": 1.0, "stepsize": fm.stepsize})
    idx = np.asarray(data["i_test"])[:1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(build.LAUNCHES)
    with shapes:
        out = renderer.render_viewpoints(
            lambda aux, ro, rd, vd: fwd_core(aux, ro, rd, vd, None),
            poses=np.asarray(data["poses"])[idx], HW=np.asarray(data["HW"])[idx],
            Ks=np.asarray(data["Ks"])[idx], gt_imgs=np.asarray(data["images"])[idx],
            chunk=RENDER_CHUNK, aux=params, log_fn=lambda m: log(f"[10c] {m}"),
            device="cuda")
    render_counts = launches_since(before)
    H, W = (int(v) for v in np.asarray(data["HW"])[idx[0]])
    if out["rgbs"].shape != (1, H, W, 3) or not np.isfinite(out["rgbs"]).all() or \
            render_counts != {"march_forward": -(-H * W // RENDER_CHUNK)}:
        raise AssertionError(f"[10c] rendered {out['rgbs'].shape}, launches {render_counts}")
    log(f"[10c] one test view of {H}x{W} on {card}: {out['seconds'][0] * 1e3:.1f} ms, psnr "
        f"{out['psnrs'][0]:.3f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {render_counts}")
    return [counts, render_counts]


def check_sfm(scene: str, data: dict, factor: int) -> str:
    """Phase 11d's gate on what ``--program sfm`` wrote from a
    ``write_colmap_scene`` capture of ``forward_facing_scene``: each row of
    ``poses_bounds.npy`` holds its view's pose in the LLFF storage convention
    within ``SFM_POSE_TOL`` and (H, W, focal) at the full resolution; its
    bounds (the 0.1 and 99.9 percentiles of the depths of the points it sees)
    span the scene: near on the ball's front half (depths 3 to 4 from every
    camera), far at the wall (depth 8). Returns a summary."""
    import numpy as np

    rows = np.load(os.path.join(scene, "poses_bounds.npy"))
    err = 0.0
    for row, c2w, K, hw in zip(rows, data["poses"], data["Ks"], data["HW"]):
        c2w = np.asarray(c2w, np.float64)
        want = np.concatenate([-c2w[:3, 1:2], c2w[:3, 0:1], c2w[:3, 2:4],
                               np.array([[hw[0]], [hw[1]], [K[0][0]]]) * factor], 1)
        err = max(err, float(np.abs(row[:15].reshape(3, 5) - want).max()))
    near, far = rows[:, 15], rows[:, 16]
    if len(rows) != len(data["poses"]) or not err < SFM_POSE_TOL or \
            not ((3.0 <= near) & (near < 4.0)).all() or not np.allclose(far, 8.0, atol=1e-6):
        raise AssertionError(f"[11d] sfm: {len(rows)} rows, pose error {err:.2e}, near "
                             f"{near.min():.4f}..{near.max():.4f}, far {far.min():.4f}.."
                             f"{far.max():.4f}")
    return (f"{len(rows)} poses within {err:.2e} of the scene's (tolerance {SFM_POSE_TOL}), "
            f"near {near.min():.4f}..{near.max():.4f}, far {far.min():.6f}..{far.max():.6f}")


def phase_madoka(tmp: pathlib.Path, card: str, paths: dict) -> list:
    """Phase 10d: custom/Madoka.py (DMPIGO, NDC rays, factor 2, 256^3 voxels
    as [X, Y, 128]) through ``run_train`` without a checkpoint on a seeded
    forward-facing capture in the LLFF layout (``MADOKA_VIEWS`` views at
    images_2 of ``MADOKA_H`` x ``MADOKA_W``): the coarse stage as the JAX
    package runs it (no ``maskout_near_cam_vox``, no per-voxel lr, no
    filter: spies fail the phase if one runs), then the fine stage on the
    coarse geometry's box, its cache seeded from the coarse alpha, its four
    boundaries compressed. Fails unless the fine stage has live samples and
    the coarse geometry's seed drops part of the fine lattice. Returns
    [train counts]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common, synthetic
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop

    t0 = time.time()
    data = synthetic.forward_facing_scene(MADOKA_VIEWS, MADOKA_H, MADOKA_W, seed=11)
    # phase 11d: the capture's cameras as a sparse COLMAP model, not
    # poses_bounds.npy, which --program sfm makes from it
    scene = synthetic.write_colmap_scene(
        str(tmp / "Madoka" / "dense"), data,
        synthetic.forward_facing_points(MADOKA_POINTS, seed=11), factor=2)
    cfg_file = compressed(MADOKA_CONFIG, tmp, "madoka", f"dict(datadir={scene!r})",
                          coarse_train=dict(N_iters=MADOKA_COARSE_STEPS),
                          fine_train=dict(N_iters=MADOKA_FINE_STEPS,
                                          pg_scale=list(MADOKA_PG_SCALE),
                                          decay_after_scale=COMPRESSED_DECAY))
    t_sfm = time.time()
    run_cli(["--config", cfg_file, "--program", "sfm"])
    sfm_s = time.time() - t_sfm
    sfm_line = check_sfm(scene, data, factor=2)
    cfg = loader.load_config(cfg_file)
    t1 = time.time()
    data = common.load_everything(cfg)
    load_s = time.time() - t1
    ct, ft, cm, fm = (cfg.coarse_train, cfg.fine_train, cfg.coarse_model_and_render,
                      cfg.fine_model_and_render)
    own = loader.load_config(str(MADOKA_CONFIG))
    log(f"[10d] config {MADOKA_CONFIG.relative_to(ROOT)} (DMPIGO, ndc {cfg.data.ndc}, factor "
        f"{cfg.data.factor}; coarse {cm.num_voxels_rgb} voxels over {cm.mpi_depth} planes, "
        f"maskout_near_cam_vox {cm.maskout_near_cam_vox} and pervoxel_lr {ct.pervoxel_lr} "
        f"skipped as in the JAX package; fine {fm.num_voxels_rgb} voxels over {fm.mpi_depth} "
        f"planes, rgbnet {fm.rgbnet_dim}/{fm.rgbnet_width}); cuts: {ct.N_iters} coarse steps of "
        f"{own.coarse_train.N_iters}, {ft.N_iters} fine steps of {own.fine_train.N_iters}, "
        f"boundaries {list(own.fine_train.pg_scale)} compressed to {list(ft.pg_scale)}, "
        f"decay_after_scale {own.fine_train.decay_after_scale} -> {ft.decay_after_scale}; "
        f"{MADOKA_VIEWS} views and their sparse model of {MADOKA_POINTS} points written in "
        f"{t_sfm - t0:.1f} s; [11d] --program sfm {sfm_s:.2f} s: {sfm_line}; the capture "
        f"loaded in {load_s:.2f} s")
    stamps, bounds, psnr = [], [], []

    def callback(step, metrics):
        if not np.isfinite(float(metrics["loss"])):  # synchronises the step
            raise AssertionError(f"[10d] step {step}: loss {float(metrics['loss'])}")
        stamps.append((time.perf_counter(), torch.cuda.max_memory_allocated() / 1e9))
        psnr.append(float(metrics["psnr"]))
        torch.cuda.reset_peak_memory_stats()
        if "pg_scale" in metrics:
            bounds.append(metrics["pg_scale"])

    from unboundednerfpytorch_tpu_torch.models import dvgo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    spies = dvgo_spies()
    skipped = Spy(dvgo, "maskout_near_cam_vox")
    seed = Spy(dvgo, "coarse_mask_fn")
    t_start = time.perf_counter()
    with spies[0], spies[1], spies[2], spies[3], skipped, seed, \
            PathShapes() as paths["10d Madoka.py"]:
        family, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cuda", log_fn=log,
                                                 log_every=100, callback=callback)
    counts = dict(build.LAUNCHES)
    steps = ct.N_iters + ft.N_iters
    want = {"march_forward": steps, "march_backward": steps,
            "masked_adam": adam_wanted("[10d]", steps)}
    if ft.weight_tv_density > 0 or ft.weight_tv_k0 > 0 or ct.weight_tv_density > 0:
        raise AssertionError("[10d] a TV weight is set: tv_add_grad would launch")
    if counts != want or len(stamps) != steps or family != "dmpigo":
        raise AssertionError(f"[10d] {family}: launch counts {counts} != {want}, "
                             f"{len(stamps)} steps")
    if spies[0].calls or spies[1].calls or skipped.calls:
        raise AssertionError(f"[10d] the JAX package skips these outside DVGO: "
                             f"voxel_count_views {len(spies[0].calls)}, in_maskcache "
                             f"{len(spies[1].calls)}, maskout {len(skipped.calls)}")
    # The wall behind the ball fills every view, so the box can shrink only
    # in depth, and a plane voxel that few cameras see may keep the alpha it
    # starts with (about 1/64 at 256 / mpi_depth, over bbox_thres): the fine
    # box may be the whole frustum box. What the coarse geometry gives
    # the fine stage is its occupancy seed, which must drop part of the
    # fine lattice (taken at full width on the fine box), and which the
    # cache carries through the boundaries
    live_samples("[10d]", spies[2], spies[3], bounds, smaller=False)
    with torch.no_grad():
        kept = float(seed.calls[0].result(mcfg.world_size, mcfg.xyz_min,
                                          mcfg.xyz_max).float().mean())
    log(f"[10d] the occupancy seed from the coarse geometry keeps {100 * kept:.2f}% of the "
        f"fine lattice {tuple(mcfg.world_size)}")
    if len(seed.calls) != 1 or not 0.0 < kept < 1.0 or not bounds[-1]["occupancy"] < 1.0:
        raise AssertionError(f"[10d] the coarse stage did not shape the fine one: its seed "
                             f"keeps {kept:.4f} of the fine lattice, the cache "
                             f"{bounds[-1]['occupancy']:.4f} after the last boundary")
    if not psnr[ct.N_iters - 1] > psnr[0] + 5:
        raise AssertionError(f"[10d] the coarse stage did not learn: PSNR {psnr[0]:.2f} -> "
                             f"{psnr[ct.N_iters - 1]:.2f}")
    if mcfg.world_size[2] != fm.mpi_depth or params.mask_cache.mask.shape != mcfg.world_size:
        raise AssertionError(f"[10d] fine world {mcfg.world_size}")
    dts = np.diff([t_start] + [t for t, _ in stamps]) * 1e3
    peaks = [p for _, p in stamps]
    first = ct.N_iters + ft.pg_scale[-1] + 1 + WARMUP_STEPS
    log(f"[10d] Madoka.py on {card}: coarse PSNR by step "
        f"{[(k, round(psnr[k - 1], 2)) for k in range(100, ct.N_iters + 1, 100)]}, ms/step median "
        f"{float(np.median(dts[2:ct.N_iters])):.2f}; fine grids {mcfg.world_size}, PSNR "
        f"{[round(x, 2) for x in psnr[ct.N_iters:]]}, ms/step "
        f"{[round(float(t), 1) for t in dts[ct.N_iters:]]} (the first with the stage's set-up), "
        f"at full width median {float(np.median(dts[first - 1:])):.1f}; peak memory of the "
        f"coarse stage {max(peaks[:ct.N_iters]):.2f} GB, of the fine stage "
        f"{max(peaks[ct.N_iters:]):.2f} GB; launches {counts}")
    return [counts]


def phase_tune_pose(tmp: pathlib.Path, card: str, paths: dict) -> list:
    """Phase 10e: the pose tuner. (1) ``--program tune_pose`` through the
    command line on 10a's trained ``fine_last`` (``TUNE_STEPS`` steps at full
    width): ms per step, ``march_forward`` and ``march_backward`` once a step
    and nothing else, ``tuned_poses.npy``; the first step's delta gradient
    equal to the CPU's plain path on the same pixel picks (``TUNE_GRAD_TOL``).
    (2) A recovery: a fine-only DVGO trained on the card on four textured
    spheres at different depths; the training poses perturbed by seeded 1-3
    degree rotations and 1-3 % translations, the images still of the true
    poses; after ``RECOVER_STEPS`` steps the mean rotation and translation
    errors must have halved.
    Returns [the launch counts of (1), of (2)'s training and of its
    tuning]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.train import pose_tune as pt
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    ape_file = str(tmp / "ape_cli.py")  # 10a's
    cfg = loader.load_config(ape_file)
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    first = {}
    stamps = []

    def on_step(args, kwargs):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if "grad" not in first:
            first["grad"] = args[0].param_groups[0]["params"][0].grad.detach().cpu().clone()

    reset_counts()
    t0 = time.time()
    with Spy(pt, "pick_pixels") as picks, Spy(torch.optim.Adam, "step", before=on_step,
                                              keep=False), \
            PathShapes() as paths["10e tune_pose"]:
        run_cli(["--config", ape_file, "--program", "tune_pose", "--tune_steps",
                 str(TUNE_STEPS)])
    total_s = time.time() - t0
    counts = dict(build.LAUNCHES)
    want = {"march_forward": TUNE_STEPS, "march_backward": TUNE_STEPS}
    tuned = np.load(os.path.join(exp_dir, "tuned_poses.npy"))
    if counts != want or not np.isfinite(tuned).all() or len(picks.calls) != TUNE_STEPS:
        raise AssertionError(f"[10e] tune_pose: launches {counts} (want {want}), "
                             f"{len(picks.calls)} steps, tuned poses finite "
                             f"{np.isfinite(tuned).all()}")
    step_ms = np.diff(stamps) * 1e3
    # the first step's gradient against the CPU's plain path at the same picks
    data = common.load_everything(cfg)
    i_train = np.asarray(data["i_train"])
    _, mcfg, params, _, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"), device="cpu",
                                            with_opt_state=False)
    params.requires_grad_(False)
    fwd = loop.make_forward(mcfg, {"near": float(data["near"]), "far": float(data["far"]),
                                   "bg": 1.0 if cfg.data.white_bkgd else 0.0,
                                   "stepsize": cfg.fine_model_and_render.stepsize})
    delta = torch.zeros((len(i_train), 6), requires_grad=True)
    t1 = time.time()
    loss = pt.tune_loss(lambda ro, rd, vd: fwd(params, ro, rd, vd, None), delta,
                        torch.as_tensor(np.asarray(data["images"])[i_train]),
                        torch.as_tensor(np.asarray(data["poses"])[i_train][:, :3, :4]),
                        torch.as_tensor(np.asarray(data["Ks"])[i_train]),
                        tuple(p.cpu() for p in picks.calls[0].result),
                        inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
                        flip_y=cfg.data.flip_y)
    loss.backward()
    cpu_s = time.time() - t1
    got, ref = first["grad"], delta.grad
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    if scale == 0 or float(got.abs().max()) == 0 or \
            bool((err > TUNE_GRAD_TOL[0] * scale + TUNE_GRAD_TOL[1] * ref.abs()).any()):
        raise AssertionError(f"[10e] the first step's delta gradient: card against CPU "
                             f"max error {float(err.max()):.3e} of {scale:.3e}")
    SHARED["10e"] = {"grad": got, "picks": [p.cpu() for p in picks.calls[0].result]}
    log(f"[10e] tune_pose on {card}: {TUNE_STEPS} steps of {len(picks.calls[0].result[0])} "
        f"pixels over {len(i_train)} views at full width {tuple(mcfg.world_size)}; ms per tune "
        f"step {[round(float(t), 1) for t in step_ms]}, median "
        f"{float(np.median(step_ms[1:])):.1f}; launches {counts}; the command {total_s:.1f} s. "
        f"First-step delta gradient, card against the CPU's plain path on the same picks "
        f"({cpu_s:.1f} s on the CPU): max |error| {float(err.max()):.3e}, max |grad| "
        f"{scale:.3e} (tolerance {TUNE_GRAD_TOL[0]} of it + {TUNE_GRAD_TOL[1]} relative)")

    # (2) recovery on a model that has learned a scene where a pose is
    # well-posed: spheres at different depths, trained here
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.probes import pose_recovery as pr

    t1 = time.time()
    data = synthetic.cluster_scene(RECOVER_VIEWS, RECOVER_HW, RECOVER_HW, seed=0)
    scene_s = time.time() - t1
    reset_counts()
    t1 = time.time()
    with PathShapes() as paths["10e recovery model"]:
        model, family, mcfg, psnr = pr.train_model(data, RECOVER_VOXELS, RECOVER_TRAIN_STEPS,
                                                   RECOVER_RAYS, "cuda")
    train_s = time.time() - t1
    tcounts = dict(build.LAUNCHES)
    want = {"march_forward": RECOVER_TRAIN_STEPS, "march_backward": RECOVER_TRAIN_STEPS,
            "masked_adam": adam_wanted("[10e]", RECOVER_TRAIN_STEPS)}
    if tcounts != want or family != "dvgo":
        raise AssertionError(f"[10e] the recovery's model: {family}, launches {tcounts} != {want}")
    i_train = np.asarray(data["i_train"])
    true = np.asarray(data["poses"])[i_train][:, :3, :4].astype(np.float64)
    start = pr.perturb(true, np.random.default_rng(12), RECOVER_DEG, RECOVER_SHIFT)
    images = np.asarray(data["images"])[i_train]
    Ks = np.asarray(data["Ks"])[i_train]
    reset_counts()
    t1 = time.time()
    with PathShapes() as paths["10e recovery"]:
        tuned, _, _ = pt.tune_poses(model, images, start.astype(np.float32), Ks,
                                       steps=RECOVER_STEPS, lr=RECOVER_LR,
                                       n_rand=RECOVER_RAYS, device="cuda",
                                       log_fn=lambda m: None)
    recover_s = time.time() - t1
    rcounts = dict(build.LAUNCHES)

    # the objective at the true, perturbed and tuned poses, on the same pixels
    def mse_at(poses) -> float:
        dev = torch.device("cuda")
        picks = pt.pick_pixels(torch.Generator(device=dev).manual_seed(13), RECOVER_PIXELS,
                               len(i_train), *images.shape[1:3])
        with torch.no_grad():
            return float(pt.tune_loss(
                model, torch.zeros((len(i_train), 6), device=dev),
                torch.as_tensor(images, device=dev),
                torch.as_tensor(np.asarray(poses, np.float32), device=dev),
                torch.as_tensor(Ks, dtype=torch.float32, device=dev), picks))

    mse = {k: mse_at(v) for k, v in (("true", true), ("start", start), ("tuned", tuned))}
    (ang0, dist0), (ang1, dist1) = pr.pose_errors(start, true), pr.pose_errors(
        tuned.astype(np.float64), true)
    log(f"[10e] recovery on {card}: four textured spheres, {len(i_train)} views of "
        f"{RECOVER_HW}x{RECOVER_HW} made in {scene_s:.2f} s; a fine-only DVGO at "
        f"{tuple(mcfg.world_size)} trained on it in {RECOVER_TRAIN_STEPS} steps, {train_s:.1f} "
        f"s, PSNR {psnr:.2f}, launches {tcounts}; {RECOVER_STEPS} tune steps of {RECOVER_RAYS} "
        f"pixels at lr {RECOVER_LR} in {recover_s:.1f} s: rotation {ang0:.3f} -> {ang1:.3f} "
        f"degrees, translation {dist0:.4f} -> {dist1:.4f} (cameras at "
        f"{float(np.linalg.norm(true[:, :, 3], axis=-1).mean()):.2f}); mse on {RECOVER_PIXELS} "
        f"pixels at the true poses {mse['true']:.6f}, perturbed {mse['start']:.6f}, tuned "
        f"{mse['tuned']:.6f}; launches {rcounts}")
    if not (ang0 > 0.5 and dist0 > 0.02 and ang1 < ang0 / 2 and dist1 < dist0 / 2) or \
            rcounts != {"march_forward": RECOVER_STEPS, "march_backward": RECOVER_STEPS}:
        raise AssertionError(f"[10e] the recovery did not halve both pose errors, or launched "
                             f"{rcounts}")
    return [counts, tcounts, rcounts]


def close_rays(tag: str, got, ref) -> str:
    """Phase 11's gate of an imported model's colours against the native
    model's (``TAR_ATOL``, ``TAR_FLIP_SHARE``). Returns a summary."""
    import numpy as np

    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).reshape(-1, 3).max(-1)
    share = float((d > TAR_ATOL).mean())
    if got.shape != ref.shape or share > TAR_FLIP_SHARE:
        raise AssertionError(f"{tag}: {got.shape} against {ref.shape}, {share:.2e} of the rays "
                             f"differ by more than {TAR_ATOL} (max {d.max():.3e})")
    return (f"max |diff| {d.max():.3e}, mean {d.mean():.3e}, {int((d > TAR_ATOL).sum())} of "
            f"{d.size} rays over {TAR_ATOL}")


def style_image(path: pathlib.Path) -> None:
    """11g's seeded style image (JPEG)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(14)
    mix = np.array([[1.0, 0.4, 0.1], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]) / 1.2
    img = np.asarray(STYLE_MEAN) + STYLE_STD * rng.standard_normal((STYLE_H, STYLE_W, 3)) @ mix
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(path, quality=95)


def mean_cov(x):
    import numpy as np

    x = np.asarray(x, np.float64).reshape(-1, 3)
    return x.mean(0), np.cov(x.T, bias=True)


def check_arf(tag: str, stylized, raw, style: pathlib.Path) -> None:
    """ARF's gate: the rendered colours ``raw`` span three directions (each
    eigenvalue of their covariance over ``ARF_RANK_FLOOR``), and the
    stylized set takes the style image's colour mean (``ARF_MEAN_TOL``) and
    covariance (``ARF_COV_REL`` of its largest entry), the style image as
    ``render/arf.py::load_style_img`` sizes it for these views."""
    import numpy as np

    from unboundednerfpytorch_tpu_torch.render import arf

    target = arf.load_style_img(str(style), *np.shape(raw)[1:3])
    (m, c), (ms, cs), (_, cc) = mean_cov(stylized), mean_cov(target), mean_cov(raw)
    eig = np.linalg.eigvalsh(cc)
    cov_err, cov_tol = float(np.abs(c - cs).max()), ARF_COV_REL * float(np.abs(cs).max())
    clipped = float(((stylized <= 0) | (stylized >= 1)).mean())
    log(f"{tag} ARF (--style_root, a seeded {STYLE_H}x{STYLE_W} style image) over "
        f"{np.shape(raw)[0]} views of {np.shape(raw)[1]}x{np.shape(raw)[2]}: the rendered "
        f"colours' covariance eigenvalues {eig.tolist()}; the stylized set's mean "
        f"{np.round(m, 6).tolist()} against the style's {np.round(ms, 6).tolist()} (max |diff| "
        f"{float(np.abs(m - ms).max()):.2e}), its covariance against the style's max |diff| "
        f"{cov_err:.2e} (tolerance {cov_tol:.2e}; the style's eigenvalues "
        f"{np.linalg.eigvalsh(cs).tolist()}); clipped share {clipped:.2e}")
    if not eig.min() > ARF_RANK_FLOOR:
        raise AssertionError(f"{tag} the rendered colours span fewer than three directions "
                             f"(eigenvalues {eig.tolist()}): the gate would not test the "
                             f"whole transform")
    if np.shape(stylized) != np.shape(raw) or not (np.abs(m - ms).max() < ARF_MEAN_TOL
                                                   and cov_err < cov_tol):
        raise AssertionError(f"{tag} the stylized views do not take the style image's colour "
                             f"statistics (tolerances {ARF_MEAN_TOL}, {cov_tol:.2e})")


def phase_tar_cli(tmp: pathlib.Path, card: str, lego_file: str, paths: dict) -> list:
    """Phases 11a and 11e on 9a's nerf/lego.py model (DVGO at full
    width). 11a: ``export_checkpoint`` of ``fine_last`` to a reference
    ``.tar`` (seconds, GB, and the seconds of its import onto the card); the
    command line's ``--program render --ft_path lego.tar`` of the test views,
    whose colours must be 9a's render of them (``close_rays``); then
    ``--program train --ft_path lego.tar`` for ``TAR_TRAIN_STEPS`` steps
    (fine stage only), resumed from the .tar's step without the optimizer's
    state, with both march kernels and masked Adam. 11e: 9a's panel
    (``i_panel`` at its last fine step) must be written, with its record,
    and its PSNR must be that of ``render_image`` of the same view through
    ``fine_last``. Returns [the render's counts, the train's, the render
    after it]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch import render as render_mod
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

    lego = loader.load_config(lego_file)
    exp_dir = os.path.join(lego.basedir, lego.expname)
    tar = str(tmp / "lego.tar")
    t0 = time.perf_counter()
    ri.export_checkpoint(os.path.join(exp_dir, "fine_last"), tar)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, imported, step, _ = ckpt.load_model(tar, device="cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    del imported

    # 11a: the .tar's render
    reset_counts()
    t0 = time.time()
    with render_spy() as renders, Spy(render_mod, "render_viewpoints") as views, \
            Spy(common, "load_everything") as loads:
        run_cli(["--config", lego_file, "--program", "render", "--render_test", "--ft_path",
                 tar])
    render_s = time.time() - t0
    data = loads.calls[0].result
    n_test = len(data["i_test"])
    chunks = -(-LEGO_H * LEGO_W // RENDER_CHUNK)
    render_counts = renders.calls[0].launches
    if render_counts != {"march_forward": n_test * chunks}:
        raise AssertionError(f"[11a] render of the .tar: launches {render_counts}")
    raw = views.calls[0].result["rgbs"]
    line = close_rays("[11a] the .tar's test views against 9a's", raw, SHARED["9a"]["rgbs"])
    log(f"[11a] lego.tar on {card}: exported from fine_last (step {step}) in {export_s:.2f} s, "
        f"{os.path.getsize(tar) / 1e9:.3f} GB on disk; imported onto the card in "
        f"{import_s:.2f} s; --program render --ft_path lego.tar ({n_test} views of "
        f"{LEGO_H}x{LEGO_W}, {[round(t * 1e3, 1) for t in views.calls[0].result['seconds']]} "
        f"ms/view, the command {render_s:.1f} s) against 9a's render of the native "
        f"checkpoint: {line}; launches {render_counts}")

    # 11e: 9a's held-out panel, against render_image of the same view and step
    with open(os.path.join(exp_dir, "panels", "panels.jsonl")) as f:
        records = [json.loads(x) for x in f]
    _, mcfg, params, _, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"), device="cuda",
                                            with_opt_state=False)
    params.requires_grad_(False)
    fwd = loop.make_forward(mcfg, {"near": float(data["near"]), "far": float(data["far"]),
                                   "bg": 1.0 if lego.data.white_bkgd else 0.0,
                                   "stepsize": lego.fine_model_and_render.stepsize})
    view = int(np.asarray(data["i_test"])[0])
    rgb, _, _ = renderer.render_image(lambda ro, rd, vd: fwd(params, ro, rd, vd, None),
                                      LEGO_H, LEGO_W, np.asarray(data["Ks"])[view],
                                      np.asarray(data["poses"])[view][:3, :4], device="cuda")
    gt = np.asarray(data["images"][view], np.float32)
    psnr = -10.0 * np.log10(max(float(np.mean((gt - rgb) ** 2)), 1e-12))
    panel = os.path.join(exp_dir, records[-1]["panel"]) if records else ""
    log(f"[11e] the panel of 9a's fine step {LEGO_FINE_STEPS}: {records}, "
        f"{os.path.getsize(panel) if panel else 0} bytes; psnr {SHARED['9a']['panel']:.6f} "
        f"against render_image of view {view} through fine_last {psnr:.6f}")
    if [(r["stage"], r["step"]) for r in records] != [("fine", LEGO_FINE_STEPS)] or \
            not os.path.isfile(panel) or abs(SHARED["9a"]["panel"] - psnr) > 1e-4 or \
            abs(records[-1]["psnr"] - round(psnr, 3)) > 1e-3:
        raise AssertionError("[11e] the panel is missing, or its PSNR is not the view's")
    del params

    # 11a: train from the .tar, the fine stage alone
    cfg_file = tmp / "lego_tar.py"
    cfg_file.write_text(f"_base_ = {lego_file!r}\nexpname = 'lego_tar'\n"
                        f"coarse_train = dict(N_iters=0)\n"
                        f"fine_train = dict(N_iters={step + TAR_TRAIN_STEPS}, i_panel=0)\n")
    reset_counts()
    t0 = time.time()
    with render_spy() as renders, PathShapes() as paths["11a lego.tar train"]:
        lines = run_cli(["--config", str(cfg_file), "--ft_path", tar, "--i_print", "1",
                         "--render_test"])
    train_s = time.time() - t0
    counts = check_cli_run("[11a]", dict(build.LAUNCHES), renders.calls[-1], TAR_TRAIN_STEPS,
                           n_test, (LEGO_H, LEGO_W),
                           per_step={"march_forward": 1, "march_backward": 1})
    said = f"fine: resumed from {tar} at step {step} (without the optimizer's state"
    meta = json.load(open(tmp / "logs" / "lego_tar" / "fine_last" / "meta.json"))
    if not any(said in x for x in lines) or meta["global_step"] != step + TAR_TRAIN_STEPS:
        raise AssertionError(f"[11a] train --ft_path lego.tar: not resumed from the .tar, or "
                             f"fine_last at step {meta['global_step']}")
    log(f"[11a] --program train --ft_path lego.tar: {TAR_TRAIN_STEPS} steps from step {step}, "
        f"fresh moments, the command {train_s:.1f} s; fine_last "
        f"{dir_gb(tmp / 'logs' / 'lego_tar' / 'fine_last'):.3f} GB")
    return [render_counts, *counts]


def phase_tar_in_memory(exp_dir: str, data: dict, cfg, card: str) -> list:
    """Phase 11b: phase 4's bicycle_single model (seven banks of 199^3 in
    bfloat16, imprinted by phase 5) through ``convert_to_reference``, a
    ``torch.save`` into memory, ``torch.load`` and ``convert_reference_ckpt``
    onto the card (a .tar of it, with float32 grids, would not fit beside
    the other phases' checkpoints on the disk). Every leaf must come back
    with its values (each bfloat16 value exactly in float32), and one render
    chunk of a test view through the imported model must give the native
    one's colours (``close_rays``). Returns [the imported chunk's counts]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

    family, mcfg, params, step, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"),
                                                    device="cuda", with_opt_state=False)
    params.requires_grad_(False)
    t0 = time.perf_counter()
    ref = ri.convert_to_reference(family, mcfg, params, global_step=step)
    buf = io.BytesIO()
    torch.save(ref, buf)
    del ref
    export_s, nbytes = time.perf_counter() - t0, buf.tell()
    t0 = time.perf_counter()
    buf.seek(0)
    back = torch.load(buf, weights_only=False)
    del buf
    fam2, cfg2, p2, step2 = ri.convert_reference_ckpt(back, device="cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    del back
    cfg2 = ri.overlay_render_knobs(cfg2, cfg.fine_model_and_render)
    same = (fam2, step2) == (family, step)
    for name in ("density", "k0"):
        a, b = getattr(p2, name).grid, getattr(params, name).grid
        same = same and a.dtype == torch.float32 and torch.equal(a, b.float())
    for x, y in zip(p2.rgbnet.layers, params.rgbnet.layers):
        same = same and torch.equal(x.weight, y.weight) and torch.equal(x.bias, y.bias)
    same = same and torch.equal(p2.mask_cache.mask, params.mask_cache.mask) and \
        p2.act_shift == float(np.float32(params.act_shift))
    if not same:
        raise AssertionError("[11b] a leaf did not come back from the reference checkpoint")
    moved = {f.name: (getattr(mcfg, f.name), getattr(cfg2, f.name))
             for f in dataclasses.fields(mcfg) if getattr(mcfg, f.name) != getattr(cfg2, f.name)}
    view = int(np.asarray(data["i_test"])[0])
    H, W = (int(v) for v in np.asarray(data["HW"])[view])
    with torch.no_grad():
        ro, rd, vd = (x.reshape(-1, 3) for x in ray_ops.get_rays_of_a_view(
            H, W, torch.as_tensor(np.asarray(data["Ks"])[view], device="cuda"),
            torch.as_tensor(np.asarray(data["poses"])[view][:3, :4], device="cuda")))
        mid = slice(H * W // 2 - RENDER_CHUNK // 2, H * W // 2 + RENDER_CHUNK // 2)
        kw = {"near": float(data["near"]), "far": float(data["far"]), "bg": 0.0,
              "stepsize": cfg.fine_model_and_render.stepsize}
        want = loop.make_forward(mcfg, kw)(params, ro[mid], rd[mid], vd[mid], None).rgb_marched
        reset_counts()
        got = loop.make_forward(cfg2, kw)(p2, ro[mid], rd[mid], vd[mid], None).rgb_marched
        counts = dict(build.LAUNCHES)
    line = close_rays("[11b] the imported chunk", got.cpu().numpy(), want.cpu().numpy())
    log(f"[11b] bicycle_single (FourierGrid, grids {tuple(params.k0.grid.shape)} "
        f"{params.k0.grid.dtype}) on {card}: convert_to_reference + torch.save into memory "
        f"{export_s:.2f} s, {nbytes / 1e9:.3f} GB (float32 grids); torch.load + "
        f"convert_reference_ckpt onto the card {import_s:.2f} s; every leaf back with its "
        f"values (grids as float32); config fields moved by the float32 storage: {moved}; a "
        f"render chunk of {RENDER_CHUNK} rays of test view {view} against the native model: "
        f"{line}; launches {counts}")
    if counts != {"march_forward": 1}:
        raise AssertionError(f"[11b] the imported chunk launched {counts}")
    return [counts]


def phase_tar_tune(tmp: pathlib.Path, card: str, paths: dict) -> list:
    """Phase 11c: 10a's linemod/ape.py model exported to a reference .tar,
    then ``--program tune_pose --ft_path ape.tar`` for ``TAR_TRAIN_STEPS``
    steps: its first step draws 10e's pixels (the same seed), and its delta
    gradient must be 10e's on the native checkpoint within
    ``TUNE_GRAD_TOL``. Returns [its launch counts]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import pose_tune as pt
    from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

    ape_file = str(tmp / "ape_cli.py")  # 10a's
    cfg = loader.load_config(ape_file)
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    tar = str(tmp / "ape.tar")
    t0 = time.perf_counter()
    ri.export_checkpoint(os.path.join(exp_dir, "fine_last"), tar)
    export_s = time.perf_counter() - t0
    first = {}

    def on_step(args, kwargs):
        if "grad" not in first:
            first["grad"] = args[0].param_groups[0]["params"][0].grad.detach().cpu().clone()

    reset_counts()
    t0 = time.time()
    with Spy(pt, "pick_pixels") as picks, Spy(torch.optim.Adam, "step", before=on_step,
                                              keep=False), \
            PathShapes() as paths["11c ape.tar tune_pose"]:
        run_cli(["--config", ape_file, "--program", "tune_pose", "--ft_path", tar,
                 "--tune_steps", str(TAR_TRAIN_STEPS)])
    total_s = time.time() - t0
    counts = dict(build.LAUNCHES)
    want = {"march_forward": TAR_TRAIN_STEPS, "march_backward": TAR_TRAIN_STEPS}
    native = SHARED["10e"]
    same_picks = all(torch.equal(a.cpu(), b) for a, b in zip(picks.calls[0].result,
                                                              native["picks"]))
    got, ref = first["grad"], native["grad"]
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    log(f"[11c] --program tune_pose --ft_path ape.tar on {card}: exported in {export_s:.2f} s, "
        f"{os.path.getsize(tar) / 1e9:.3f} GB; {TAR_TRAIN_STEPS} steps, the command "
        f"{total_s:.1f} s; launches {counts}; the first step's pixels 10e's: {same_picks}; its "
        f"delta gradient against 10e's on the native checkpoint: max |error| "
        f"{float(err.max()):.3e} of {scale:.3e} (tolerance {TUNE_GRAD_TOL[0]} of it + "
        f"{TUNE_GRAD_TOL[1]} relative)")
    if counts != want or not same_picks or scale == 0 or \
            bool((err > TUNE_GRAD_TOL[0] * scale + TUNE_GRAD_TOL[1] * ref.abs()).any()) or \
            not np.isfinite(np.load(os.path.join(exp_dir, "tuned_poses.npy"))).all():
        raise AssertionError("[11c] tune_pose from the .tar: launches, pixels or gradient")
    return [counts]


def phase_serve(tmp: pathlib.Path, card: str, lego_file: str) -> list:
    """Phase 11f: ``tools/serve.py``'s ``RenderService`` over 9a's lego
    checkpoint and over 11a's ``lego.tar``, served on localhost: ``/health``
    and ``/meta`` (the checkpoint's family, step and box centre), and
    ``/render`` at ``SERVE_POSES`` of ``SERVE_W`` x ``SERVE_H``, each PNG
    decoded equal to ``to8b`` of ``render_image`` of the same pose. Prints
    ms per request. Returns [the requests' launch counts]."""
    import threading
    import urllib.request
    from http.server import HTTPServer

    import numpy as np
    from PIL import Image

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data.synthetic import look_at_pose
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.tools import serve
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import metrics as M

    lego = loader.load_config(lego_file)
    native = os.path.join(lego.basedir, lego.expname, "fine_last")
    meta = json.load(open(os.path.join(native, "meta.json")))
    lo, hi = (np.asarray(meta["model_kwargs"][k], np.float64) for k in ("xyz_min", "xyz_max"))
    reset_counts()
    total = {}
    for label, path in (("fine_last", native), ("lego.tar", str(tmp / "lego.tar"))):
        t0 = time.perf_counter()
        service = serve.RenderService(path, device="cuda")
        start_s = time.perf_counter() - t0
        srv = HTTPServer(("127.0.0.1", 0), serve.make_handler(service))
        port = srv.server_address[1]
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
                return r.read()

        try:
            health, got_meta = json.loads(get("/health")), json.loads(get("/meta"))
            if health.pop("status") != "ok" or health != got_meta or \
                    (got_meta["family"], got_meta["step"]) != ("dvgo", meta["global_step"]) or \
                    not np.allclose(got_meta["scene_center"], (lo + hi) / 2, atol=1e-6):
                raise AssertionError(f"[11f] {label}: /health {health}, /meta {got_meta}")
            fwd = loop.make_forward(service.mcfg, service.render_kwargs, cache=service.cache)
            ms = []
            for theta, phi in SERVE_POSES:
                before = dict(build.LAUNCHES)
                t0 = time.perf_counter()
                png = get(f"/render?theta={theta}&phi={phi}&w={SERVE_W}&h={SERVE_H}")
                ms.append((time.perf_counter() - t0) * 1e3)
                for k, v in launches_since(before).items():
                    total[k] = total.get(k, 0) + v
                got = np.asarray(Image.open(io.BytesIO(png)))
                th, ph = np.radians(theta), np.radians(phi)
                center = np.asarray(got_meta["scene_center"])
                pos = center + 1.2 * got_meta["scene_radius"] * np.array(
                    [np.cos(ph) * np.cos(th), np.cos(ph) * np.sin(th), np.sin(ph)])
                K = np.array([[1.2 * SERVE_W, 0, SERVE_W / 2], [0, 1.2 * SERVE_W, SERVE_H / 2],
                              [0, 0, 1]], np.float32)
                rgb, _, _ = renderer.render_image(
                    lambda ro, rd, vd: fwd(service.params, ro, rd, vd, None), SERVE_H, SERVE_W,
                    K, look_at_pose(pos, center)[:3, :4], device="cuda")
                if got.shape != (SERVE_H, SERVE_W, 3) or not np.array_equal(got, M.to8b(rgb)) \
                        or got.std() == 0:
                    raise AssertionError(f"[11f] {label}: /render at ({theta}, {phi}) is not "
                                         f"render_image's view")
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join()
        log(f"[11f] RenderService over {label} on {card}: loaded with its render cache in "
            f"{start_s:.2f} s; /meta {got_meta}; /render of {SERVE_W}x{SERVE_H} at "
            f"{list(SERVE_POSES)}: {[round(t, 1) for t in ms]} ms per request, each PNG equal "
            f"to render_image's view")
        del service
    want = {"march_forward": 2 * len(SERVE_POSES) * -(-SERVE_W * SERVE_H // RENDER_CHUNK)}
    if total != want:
        raise AssertionError(f"[11f] the requests launched {total}, want {want}")
    return [total]


# ---------------------------------------------------------------------------
# phase 12: FourierGrid's fast paths on phase 4's model, as phase 5 left it


def test_view_rays(data, cfg, idx: int):
    """The flat rays (ro, rd, vd) of view ``idx`` on the card, with the
    data's ray flags."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops

    Hv, Wv = (int(v) for v in np.asarray(data["HW"])[idx])
    with torch.no_grad():
        out = ray_ops.get_rays_of_a_view(
            Hv, Wv, torch.as_tensor(np.asarray(data["Ks"])[idx], device="cuda"),
            torch.as_tensor(np.asarray(data["poses"])[idx][:3, :4], device="cuda"),
            inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
    return [x.reshape(-1, 3) for x in out]


def view_ms(render_one, repeats: int = 2) -> tuple:
    """(median ms of ``repeats`` renders after a warm-up one, the last
    render's (rgb, depth, alphainv_last))."""
    import numpy as np

    out = render_one()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = render_one()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def load_phase5(exp_dir: str):
    """Phase 5's checkpoint (phase 4's model, the scene imprinted, the final
    ``fast_color_thres``) on the card: (config, params without a grad)."""
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    _, mcfg, params, _, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"), device="cuda",
                                            with_opt_state=False)
    params.requires_grad_(False)
    return mcfg, params


def phase_fast_render(mcfg, params, data, cfg, card: str) -> list:
    """Phase 12a (the hierarchical probe), 12d (the adaptive render) and the
    layout measurement, on phase 5's model (``load_phase5``) and its first
    test view, through the config's render cache (two-stage, the density
    baked). Returns the launch counts of the three paths, each counted from
    0."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer

    idx = int(np.asarray(data["i_test"])[0])
    Hv, Wv = (int(v) for v in np.asarray(data["HW"])[idx])
    K, c2w = np.asarray(data["Ks"])[idx], np.asarray(data["poses"])[idx][:3, :4]
    flags = dict(inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
    ro, rd, vd = test_view_rays(data, cfg, idx)
    S, cs, stride = 2 * mcfg.n_inner, FAST_PROBE_STRIDE, mcfg.budget_probe_stride
    n_g = -(-S // cs)
    auto = dataclasses.replace(mcfg, probe_coarse_stride=cs)
    c_g = min(-(-int(1.5 * mcfg.sample_budget) // cs), n_g)
    counts = []

    # ---- 12a: the selections, chunk by chunk, and the view's time
    reset_counts()
    equal_ample = equal_auto = prefix_auto = 0
    with torch.no_grad():
        for a in range(0, ro.shape[0], RENDER_CHUNK):
            sl = slice(a, a + RENDER_CHUNK)
            got = {}
            for tag, c in (("flat", mcfg), ("auto", auto),
                           ("ample", dataclasses.replace(auto, probe_candidate_groups=n_g))):
                pts, _, t = fg.sample_ray(c, ro[sl], rd[sl])
                got[tag] = fg.budget_select(params, c, pts, ro[sl], rd[sl], t)
            (sf, mf), (sa, ma), (sx, mx) = got["flat"], got["auto"], got["ample"]
            if not (torch.equal(sx, sf) and torch.equal(mx, mf)):
                raise AssertionError("[12a] the hierarchical selection with a candidate group "
                                     "for every group is not the flat probe's")
            equal_ample += int(mf.shape[0])
            same = (sa == sf).all(-1) & (ma == mf).all(-1)
            equal_auto += int(same.sum())
            k = ma.sum(-1, keepdim=True)
            prefix = (((sa == sf) | ~ma).all(-1) & (k[:, 0] <= mf.sum(-1))
                      & (ma == (torch.arange(ma.shape[1], device="cuda") < k)).all(-1))
            prefix_auto += int(prefix.sum())
    n = int(ro.shape[0])
    if prefix_auto != n:
        raise AssertionError(f"[12a] {n - prefix_auto} rays' automatic-candidate selections are "
                             "not a prefix of the flat probe's")
    cache = fg.build_render_cache(params, mcfg, log_fn=lambda m: log(f"[12a] {m}"))

    def render_view(c, cache_now, rays_fn=None):
        return renderer.render_image(
            lambda aux, o, d, v: fg.forward(aux[0], c, o, d, v, cache=aux[1]), Hv, Wv, K, c2w,
            chunk=RENDER_CHUNK, aux=(params, cache_now), rays_fn=rays_fn, device="cuda", **flags)

    ms_flat, img_flat = view_ms(lambda: render_view(mcfg, cache))
    ms_hier, img_hier = view_ms(lambda: render_view(auto, cache))
    counts.append(dict(build.LAUNCHES))
    rec = {"phase": "12a", "card": card, "view": idx, "rays": n,
           "selection_equal_flat_ample_candidates": equal_ample,
           "selection_equal_flat_auto_candidates": equal_auto,
           "auto_truncations_that_keep_a_prefix": n - equal_auto,
           "probe_rows_a_ray": {"flat": S // stride, "coarse": n_g,
                                "fine": c_g * cs // stride},
           "candidate_groups_auto": c_g, "view_ms_flat": ms_flat,
           "view_ms_hierarchical": ms_hier,
           "max_abs_diff_of_the_views": float(np.abs(img_hier[0] - img_flat[0]).max()),
           "launches": counts[-1]}
    log(json.dumps(rec))

    # ---- 12d: the adaptive render through render_image's rays_fn
    reset_counts()
    report = {}
    adaptive = lambda o, d, v: fg.render_rays_adaptive(params, mcfg, cache, o, d, v, bg=0.0,
                                                       seg=ADAPTIVE_SEG, report=report)
    ms_adapt, img_adapt = view_ms(lambda: render_view(mcfg, cache, rays_fn=adaptive))
    counts.append(dict(build.LAUNCHES))
    with torch.no_grad():  # the two-stage cached forward on the same padded rays
        n_pad = (-n) % RENDER_CHUNK
        pad = lambda x: torch.cat([x, x[-1:].expand(n_pad, 3)])
        pr, pd_, pv = (pad(x) for x in (ro, rd, vd))
        parts = [fg.forward(params, mcfg, pr[a:a + RENDER_CHUNK], pd_[a:a + RENDER_CHUNK],
                            pv[a:a + RENDER_CHUNK], cache=cache)
                 for a in range(0, pr.shape[0], RENDER_CHUNK)]
        ref_mask = torch.cat([r.mask for r in parts])[:n]
        ref = [torch.cat([getattr(r, f) for r in parts])[:n].cpu().numpy().reshape(n, -1)
               for f in ("rgb_marched", "depth", "alphainv_last")]
    got = [np.asarray(x).reshape(n, -1) for x in img_adapt]
    diff = np.max([np.abs(g - r).max(-1) for g, r in zip(got, ref)], axis=0)
    flipped = (report["mask"][:n] != ref_mask)
    flip_rays = flipped.any(-1).cpu().numpy()
    over = diff > ADAPTIVE_ATOL
    rec = {"phase": "12d", "card": card, "view": idx, "rays": n, "seg": ADAPTIVE_SEG,
           "alive_after_phase_a": report["alive"], "bucket": report["bucket"],
           "rays_padded": int(pr.shape[0]), "view_ms_adaptive": ms_adapt,
           "view_ms_two_stage": ms_flat, "max_abs_diff": float(diff.max()),
           "rays_over_atol": int(over.sum()), "flipped_samples": int(flipped.sum()),
           "rays_with_a_flip": int(flip_rays.sum()), "atol": ADAPTIVE_ATOL,
           "launches": counts[-1]}
    log(json.dumps(rec))
    if bool((over & ~flip_rays).any()) or int(flipped.sum()) > MAX_FLIPPED_SHARE * flipped.numel():
        raise AssertionError("[12d] the adaptive render differs from the two-stage render "
                             "beyond its tolerance where no threshold flipped")
    if counts[-1] != {"march_forward": 3}:
        raise AssertionError(f"[12d] launches {counts[-1]}: one march a view")
    del report

    # ---- the layout: the packed single-stage tables against the 8-corner
    # gather from the grids (no render cache), both single-stage
    reset_counts()
    single = dataclasses.replace(mcfg, color_budget=0)
    packed = fg.build_render_cache(params, single, log_fn=lambda m: log(f"[12 layout] {m}"))
    del cache
    ms_packed, img_packed = view_ms(lambda: render_view(single, packed), repeats=1)
    del packed
    torch.cuda.empty_cache()
    corners = dataclasses.replace(single, packed_gather=False)
    if fg.build_render_cache(params, corners) is not None:
        raise AssertionError("packed_gather=False built a cache")
    ms_corners, img_corners = view_ms(lambda: render_view(corners, None), repeats=1)
    counts.append(dict(build.LAUNCHES))
    rec = {"phase": "12 layout", "card": card, "view": idx,
           "view_ms_config_cache_two_stage_baked": ms_flat,
           "view_ms_packed_single_stage": ms_packed, "view_ms_8_corner_gather": ms_corners,
           "max_abs_diff_packed_vs_8_corner": float(np.abs(img_packed[0] - img_corners[0]).max()),
           "launches": counts[-1]}
    log(json.dumps(rec))
    SHARED["12"] = {"view_ms": ms_flat}
    return counts


def phase_auto_budget(mcfg, params, exp_dir: str, data, cfg, cfg_file: str,
                      card: str) -> list:
    """Phase 12c: phase 5's command-line render with ``--auto_budget``: the
    budgets it chose, the mask's occupied share and whether the
    hierarchical probe came on (a spy on ``render.auto_budgets``), ms/view
    against phase 5's, and the PSNR of its first test view against the
    full march of the same model (``params``; no budgets, no bake), which
    must pass ``AUTO_MIN_PSNR``: on every ``AUTO_PSNR_STRIDE``-th ray of the
    view, the full march taking 664 samples a ray through 7 banks. Returns
    [the command's launch counts]."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch import render
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import metrics as M

    path = os.path.join(exp_dir, "fine_last")
    reset_counts()
    t0 = time.time()
    with Spy(render, "auto_budgets") as ab, Spy(render, "run_render") as rr:
        run_cli(["--config", cfg_file, "--program", "render", "--render_test", "--ft_path",
                 path, "--auto_budget"])
    total_s = time.time() - t0
    counts = dict(build.LAUNCHES)
    auto_cfg, got = ab.calls[0].result
    out = rr.calls[0].result["test"]
    ms = float(np.median(out["seconds"][1:])) * 1e3
    full = dataclasses.replace(mcfg, sample_budget=0, color_budget=0, density_bake_scale=0.0,
                               probe_coarse_stride=0)
    cache = fg.build_render_cache(params, full)
    idx = int(np.asarray(data["i_test"])[0])
    kw = {"near": float(data["near"]), "far": float(data["far"]), "bg": 0.0,
          "stepsize": cfg.fine_model_and_render.stepsize}
    fwd = loop.make_forward(full, kw)
    ro, rd, vd = (x[::AUTO_PSNR_STRIDE] for x in test_view_rays(data, cfg, idx))
    t0 = time.perf_counter()
    with torch.no_grad():
        img = torch.cat([fwd(params, ro[a:a + RENDER_CHUNK], rd[a:a + RENDER_CHUNK],
                             vd[a:a + RENDER_CHUNK], None, cache=cache).rgb_marched
                         for a in range(0, ro.shape[0], RENDER_CHUNK)]).cpu().numpy()
    full_s = time.perf_counter() - t0
    del cache
    torch.cuda.empty_cache()
    psnr = float(M.psnr(out["rgbs"][0].reshape(-1, 3)[::AUTO_PSNR_STRIDE], img))
    keys = ("sample_budget", "color_budget", "probe_coarse_stride", "probe_candidate_groups")
    rec = {"phase": "12c", "card": card, "budgets": {k: getattr(auto_cfg, k) for k in keys},
           "config_budgets": {k: getattr(mcfg, k) for k in keys},
           "occupancy": got["occupancy"], "hierarchical_probe": got["hierarchical"],
           "probe_rays": got["n_rays"], "occ_q": got["occ_q"], "surv_q": got["surv_q"],
           "view_ms": [round(t * 1e3, 1) for t in out["seconds"]], "median_view_ms": ms,
           "phase5_view_ms": SHARED["5"]["view_ms"], "command_s": total_s,
           "psnr_vs_full_march_db": psnr, "psnr_rays": int(ro.shape[0]),
           "full_march_s": full_s, "gate_db": AUTO_MIN_PSNR, "launches": counts}
    log(json.dumps(rec))
    if not psnr > AUTO_MIN_PSNR or got["hierarchical"] != (got["occupancy"] < 0.45):
        raise AssertionError(f"[12c] psnr {psnr} against the full march, or the probe switch")
    return [counts]


class GradGrab:
    """Stands in for the optimizer of a train step: keeps each parameter's
    gradient as the step leaves it, and updates nothing."""

    def __init__(self, params):
        self.params, self.grads = params, None

    def step(self, lr_scale: float = 1.0) -> None:
        self.grads = {k: p.grad.detach().clone() for k, p in self.params.named_parameters()
                      if p.grad is not None}


def check_grad(name: str, got, ref, tag: str = "[12b]") -> dict:
    """A gradient of the two-stage step against the single-stage step's: every
    element within 1e-4 of its value plus 1e-6 of the largest (float32 sums
    in another order). A bfloat16 gradient (the grids') is one rounding of a
    float32 index-add whose atomic adds run in any order, so two equal sums
    may round to neighbouring bfloat16 values: an element one bfloat16 step
    off is counted as such, and at most 1e-4 of the non-zero elements may
    be. Returns the summary."""
    import torch

    g, r = got.float(), ref.float()
    d = (g - r).abs()
    big = float(r.abs().max())
    ok = d <= 1e-4 * r.abs() + 1e-6 * big
    nonzero = int((r != 0).sum())
    flips = 0
    if got.dtype == torch.bfloat16:
        step = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        flips = int((~ok & (d <= step)).sum())
        ok = ok | (d <= step)
    if not bool(ok.all()) or flips > 1e-4 * max(nonzero, 1):
        raise AssertionError(f"{tag} gradient {name}: {int((~ok).sum())} elements off, {flips} "
                             f"one bfloat16 step off of {nonzero}")
    return {"max_abs_diff": float(d.max()), "max_abs": big, "nonzero": nonzero,
            "bf16_step_flips": flips}


def phase_train_two_stage(mcfg, params, data, cfg, card: str) -> list:
    """Phase 12b: phase 5's model (at full width, past phase 4's last
    boundary; it trains ``params`` in place) at ``fast_color_thres`` 1e-4 with ``train_survivor_budget``
    ``FAST_SURVIVORS``. One ``FAST_N_RAND`` batch through the train step of
    both forwards (TV off, the optimizer replaced by ``GradGrab``): the loss
    within 1e-4 relative, every gradient by ``check_grad``. The batch's rays
    are drawn at random; those with more survivors than the budget (the
    share printed) are replaced by rays without, since only for those do the
    two forwards compute the same function. Then ``FAST_STEPS`` timed steps
    of each forward (TV and masked Adam on, after a warm-up step) on random
    batches, with ``color_overflow_frac``. Returns the launch counts of the
    two timed runs."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
    from unboundednerfpytorch_tpu_torch.ops import sampling
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.train.step import TrainState, create_train_state, \
        make_train_step

    params.requires_grad_(True)
    mcfg = dataclasses.replace(mcfg, fast_color_thres=1e-4)
    two = dataclasses.replace(mcfg, train_survivor_budget=FAST_SURVIVORS)
    ft = cfg.fine_train
    store = loop.gather_training_rays(cfg, data, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    n_total = store["rgb"].shape[0]
    kw = {"near": float(data["near"]), "far": float(data["far"]), "bg": 0.0,
          "rand_bkgd": cfg.data.rand_bkgd, "stepsize": cfg.fine_model_and_render.stepsize}
    near_thres = 0.0
    if ft.weight_nearclip > 0 and data.get("near_clip"):
        near_thres = float(data["near_clip"]) / float(mcfg.scene_radius[0])
    interval = mcfg.stepsize * mcfg.voxel_size_ratio_density

    def survivors(idx):
        with torch.no_grad():
            ro, rd = store["rays_o"][idx], store["rays_d"][idx]
            pts, _, t = fg.sample_ray(mcfg, ro, rd)
            sel, m = fg.budget_select(params, mcfg, pts, ro, rd, t)
            pts = sampling.gather_samples(pts, sel)
            a = alpha_ops.raw2alpha(fg._probe_density(params, mcfg, pts), params.act_shift,
                                    interval)
            return (m & (a > mcfg.fast_color_thres)).sum(-1)

    pool = torch.randint(n_total, (4 * FAST_N_RAND,), generator=gen, device="cuda")
    n_surv = survivors(pool)
    first = n_surv[:FAST_N_RAND] > FAST_SURVIVORS
    keep = pool[n_surv <= FAST_SURVIVORS][:FAST_N_RAND]
    if keep.shape[0] < FAST_N_RAND:
        raise AssertionError("[12b] too few rays within the survivor budget")
    batch = {k: v[keep] for k, v in store.items()}
    ft_cmp = dataclasses.replace(ft, weight_tv_density=0.0, weight_tv_k0=0.0)
    out = {}
    for tag, c in (("single", mcfg), ("two_stage", two)):
        step_fn = make_train_step(loop.make_forward(c, kw), ft_cmp,
                                  world_size_max=float(max(c.world_size)), near_thres=near_thres,
                                  lr_anchor=1)
        grab = GradGrab(params)
        metrics = step_fn(TrainState(params, grab, step=100), batch)
        out[tag] = (float(metrics["loss"]), grab.grads, metrics.get("overflow_frac"))
    (l1, g1, _), (l2, g2, of2) = out["single"], out["two_stage"]
    if sorted(g1) != sorted(g2) or abs(l2 - l1) > 1e-4 * abs(l1) or float(of2) != 0.0:
        raise AssertionError(f"[12b] loss {l2} against {l1}, overflow {of2}, grads "
                             f"{sorted(g2)} against {sorted(g1)}")
    grads = {k: check_grad(k, g2[k], g1[k]) for k in g1}
    del out, g1, g2

    # stage A of the two-stage forward on that batch, alone: the density
    # probe, and of it the packing of the seven folded tables
    from unboundednerfpytorch_tpu_torch.ops import packed as packed_ops

    with torch.no_grad():
        pts, _, t = fg.sample_ray(mcfg, batch["rays_o"], batch["rays_d"])
        sel, _ = fg.budget_select(params, mcfg, pts, batch["rays_o"], batch["rays_d"], t)
        pts = sampling.gather_samples(pts, sel)
        grid = params.density.grid.detach()
        stage_a = {}
        for what, fn in (("probe_ms", lambda: fg._probe_density(params, mcfg, pts)),
                         ("pack_ms", lambda: [packed_ops.pack_corners_folded(grid[b], 16)
                                              for b in range(grid.shape[0])])):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            stage_a[what] = (time.perf_counter() - t0) * 1e3 / 3
    del batch, pts, sel, grid

    timing, counts = {}, []
    for tag, c in (("single", mcfg), ("two_stage", two)):
        reset_counts()
        step_fn = make_train_step(loop.make_forward(c, kw), ft,
                                  world_size_max=float(max(c.world_size)), near_thres=near_thres,
                                  lr_anchor=1)
        state = create_train_state(params, ft, start_step=100)
        ms, over = [], []
        for i in range(FAST_STEPS + 1):
            b = {k: v[torch.randint(n_total, (FAST_N_RAND,), generator=gen, device="cuda")]
                 for k, v in store.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step_fn(state, b)
            loss = float(m["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(loss):
                raise AssertionError(f"[12b] {tag} step: loss {loss}")
            if "overflow_frac" in m:
                over.append(float(m["overflow_frac"]))
        counts.append(dict(build.LAUNCHES))
        steps = FAST_STEPS + 1
        want = {"tv_add_grad": 2 * steps, "march_forward": steps, "march_backward": steps,
                "masked_adam": adam_wanted(f"[12b] {tag}", steps)}
        if counts[-1] != want:
            raise AssertionError(f"[12b] {tag} launches {counts[-1]} != {want}")
        timing[tag] = {"ms": [round(t, 2) for t in ms], "median_ms": float(np.median(ms[1:])),
                       "overflow_frac": over}
        del state
        torch.cuda.empty_cache()
    rec = {"phase": "12b", "card": card, "n_rand": FAST_N_RAND, "survivor_budget": FAST_SURVIVORS,
           "fast_color_thres": mcfg.fast_color_thres,
           "random_batch_overflow_share": float(first.float().mean()),
           "loss": {"single": l1, "two_stage": l2}, "grads": grads, "stage_a": stage_a,
           "steps": timing,
           "launches": counts}
    log(json.dumps(rec))
    del store
    return counts


def phase_heads(data, cfg, card: str, tv_shapes: dict) -> tuple:
    """Phase 12e: bicycle_single at full width with the coarse colour head
    (``rgbnet_dim`` 0), with the view-direction grid (``num_voxels_viewdir``
    ``HEAD_VIEWDIR``) and with appearance embeddings (``img_emb_dim``
    ``HEAD_EMB_DIM``, one a training view), each ``HEAD_STEPS`` steps of
    ``run_train`` from the full-width grids (no boundary; the analytic
    occupancy seed), ``HEAD_LRATES`` for the new groups. The first two go
    through the ``.tar`` format in memory (``convert_to_reference``, then
    ``convert_reference_ckpt``; the coarse head's dict through ``torch.save``
    and back as well, the view grid's 2.9 GB one not: 11b times that
    pickling): every leaf back, a render chunk of a test view equal to the
    native model's (``close_rays``); the third,
    whose MLP reads embeddings, has no reference counterpart and its export
    must raise. Returns (the runs' launch counts, the shapes of the new
    leaves the optimizer saw)."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

    xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid",
                                                            device="cuda")
    seed_fn = synthetic.occupancy_seed((xyz_min + xyz_max) / 2, (xyz_max - xyz_min) / 2,
                                       sphere_radius=sphere_radius_of(data))
    ft = dataclasses.replace(cfg.fine_train, N_iters=HEAD_STEPS, pg_scale=(), **HEAD_LRATES)
    idx = int(np.asarray(data["i_test"])[0])
    ro, rd, vd = test_view_rays(data, cfg, idx)
    mid = slice(ro.shape[0] // 2 - RENDER_CHUNK // 2, ro.shape[0] // 2 + RENDER_CHUNK // 2)
    kw = {"near": float(data["near"]), "far": float(data["far"]), "bg": 0.0,
          "stepsize": cfg.fine_model_and_render.stepsize}
    counts, leaves = [], {}
    for tag, head in (("coarse", dict(rgbnet_dim=0)),
                      ("viewgrid", dict(num_voxels_viewdir=HEAD_VIEWDIR)),
                      ("embeddings", dict(img_emb_dim=HEAD_EMB_DIM))):
        run_cfg = dataclasses.replace(
            cfg, fine_train=ft,
            fine_model_and_render=dataclasses.replace(cfg.fine_model_and_render, **head))
        ms = []
        stamps = [time.perf_counter()]

        def callback(step, metrics):
            if not np.isfinite(float(metrics["loss"])):
                raise AssertionError(f"[12e] {tag} step {step}: loss {metrics['loss']}")
            stamps.append(time.perf_counter())

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        _, mcfg, params, _ = loop.run_train(run_cfg, data, seed=0, device="cuda",
                                            log_fn=lambda m: None, callback=callback,
                                            coarse_mask_fn=seed_fn)
        counts.append(dict(build.LAUNCHES))
        want = {"tv_add_grad": 2 * HEAD_STEPS, "march_forward": HEAD_STEPS,
                "march_backward": HEAD_STEPS,
                "masked_adam": adam_wanted(f"[12e] {tag}", HEAD_STEPS)}
        if counts[-1] != want:
            raise AssertionError(f"[12e] {tag} launches {counts[-1]} != {want}")
        ms = np.diff(stamps) * 1e3
        new = {"vd": params.vd.grid if params.vd is not None else None,
               "img_embeddings": params.img_embeddings}
        rec = {"phase": "12e", "card": card, "head": tag, "k0": list(params.k0.grid.shape),
               "rgbnet": params.rgbnet is not None,
               "new_leaves": {k: list(v.shape) for k, v in new.items() if v is not None},
               "step_ms": [round(t, 1) for t in ms],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts[-1]}
        params.requires_grad_(False)
        if tag == "embeddings":
            if mcfg.sample_num != len(np.asarray(data["i_train"])):
                raise AssertionError(f"[12e] sample_num {mcfg.sample_num}")
            try:
                ri.convert_to_reference("FourierGrid", mcfg, params)
            except ValueError as e:
                rec["tar"] = f"export refused: {e}"
            else:
                raise AssertionError("[12e] a model whose MLP reads embeddings was exported")
        else:
            ref = ri.convert_to_reference("FourierGrid", mcfg, params, global_step=3)
            nbytes = sum(t.numel() * t.element_size() for t in ref["model_state_dict"].values())
            if nbytes < TAR_PICKLE_BYTES:  # the coarse head's: through torch.save and back
                buf = io.BytesIO()
                torch.save(ref, buf)
                buf.seek(0)
                ref = torch.load(buf, weights_only=False)
                del buf
            _, cfg2, p2, _ = ri.convert_reference_ckpt(ref, device="cuda")
            del ref
            cfg2 = ri.overlay_render_knobs(cfg2, run_cfg.fine_model_and_render)
            same = (p2.rgbnet is None) == (params.rgbnet is None)
            for name in ("density", "k0", "vd"):
                a, b = getattr(p2, name), getattr(params, name)
                same = same and (a is None) == (b is None) and (
                    a is None or torch.equal(a.grid, b.grid.float()))
            if params.rgbnet is not None:
                for x, y in zip(p2.rgbnet.layers, params.rgbnet.layers):
                    same = same and torch.equal(x.weight, y.weight) and torch.equal(x.bias, y.bias)
            same = same and torch.equal(p2.mask_cache.mask, params.mask_cache.mask)
            if not same:
                raise AssertionError(f"[12e] {tag}: a leaf did not come back from the .tar")
            with torch.no_grad():
                want_rgb = loop.make_forward(mcfg, kw)(params, ro[mid], rd[mid], vd[mid])
                got_rgb = loop.make_forward(cfg2, kw)(p2, ro[mid], rd[mid], vd[mid])
            rec["tar"] = {"gb": nbytes / 1e9, "chunk": close_rays(
                f"[12e] {tag} .tar chunk", got_rgb.rgb_marched.cpu().numpy(),
                want_rgb.rgb_marched.cpu().numpy())}
            del p2
        leaves[tag] = {k: tuple(v.shape) for k, v in new.items() if v is not None}
        log(json.dumps(rec))
        del params
        torch.cuda.empty_cache()
    return counts, leaves


def phase_fast_paths(exp_dir: str, data, cfg, cfg_file: str, card: str, tv_shapes: dict,
                     shapes) -> list:
    """Phase 12: 12a, 12d and the layout (``phase_fast_render``), 12c
    (``phase_auto_budget``), 12b (``phase_train_two_stage``) and 12e
    (``phase_heads``); ``shapes``, a ``PathShapes``, records what they hand
    the march kernels and masked Adam for 12f. Writes no checkpoint.
    Returns the launch counts of each path."""
    mcfg, params = load_phase5(exp_dir)
    with shapes:
        counts = phase_fast_render(mcfg, params, data, cfg, card)
        counts += phase_auto_budget(mcfg, params, exp_dir, data, cfg, cfg_file, card)
        counts += phase_train_two_stage(mcfg, params, data, cfg, card)
        del params
        head_counts, _ = phase_heads(data, cfg, card, tv_shapes)
    return counts + head_counts


def phase_fast_kernels(gen, kernels: list, shapes, floor: float, seen: set,
                       coarse_k0: tuple) -> None:
    """Phase 12f: both march kernels and masked Adam at the shapes phase 12's
    train steps gave them (``phase_dvgo_kernels``: [2048, 48] and [2048, 96],
    the view grid, the embeddings, the coarse head's grids), the adaptive
    render's and the renders' march at their shapes, and ``tv_add_grad`` at
    the coarse head's k0 (one bank of 3 channels)."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms

    rows = {k["name"]: k for k in kernels}
    phase_dvgo_kernels(gen, kernels, {"12": shapes}, floor, (), seen)
    w = (0.3, 0.2, 0.1)
    err = tv_case(gen, "12e coarse head k0", coarse_k0, torch.bfloat16, w)
    rows["tv_add_grad"]["max_abs_err"] = max(rows["tv_add_grad"]["max_abs_err"], err)
    # the train step's case: bf16, dense, in place
    p = torch.randn(coarse_k0, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(coarse_k0, generator=gen, device="cuda").to(torch.bfloat16)
    ms, call = kernel_ms(lambda: tv.tv_add_grad(p, g, *w, 1.0, True, out=g))
    rows["tv_add_grad"]["shapes"].append(shape_line(
        f"tv_add_grad 12e coarse head k0 {coarse_k0} bf16 in place", ms, call,
        bound_ms(3 * p.numel() * p.element_size(), 25 * p.numel())[0], floor))
    del p, g
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the Waymo city-scale path: waymo_block.py's blocks and Block-NeRF (phase 13)


def street_records(tmp: pathlib.Path) -> tuple:
    """13a's capture: the street scene (``data/synthetic.py::street_scene``,
    rendered on the card) as the Waymo release's TFRecords, a training and a
    validation file (uncompressed: the decode takes both; the CPU tests
    hold the gzipped ones), decoded by ``preprocess.decode_waymo_tfrecords``;
    each recovered camera against its view's. Returns (the decoded
    directory, its metadata)."""
    import numpy as np

    from unboundednerfpytorch_tpu_torch.data import preprocess, synthetic

    t0 = time.time()
    views, images = synthetic.street_scene(BLOCK_VIEWS, WAYMO_H, WAYMO_W, device="cuda",
                                           chunk=1 << 16)
    t1 = time.time()
    cams = [74 if i in BLOCK_OTHER_IDS else 73 for i in range(BLOCK_VIEWS)]
    train = [i for i in range(BLOCK_VIEWS) if i not in BLOCK_VAL_IDS]
    files = []
    for name, ids in (("waymo_train.tfrecord", train), ("waymo_validation.tfrecord",
                                                        BLOCK_VAL_IDS)):
        files.append(synthetic.write_waymo_tfrecords(
            str(tmp / name), [views[i] for i in ids], [images[i] for i in ids],
            [cams[i] for i in ids], compress=False))
    t2 = time.time()
    decoded = str(tmp / "waymo_block_dataset")
    meta = preprocess.decode_waymo_tfrecords(files, decoded)
    t3 = time.time()
    order = train + list(BLOCK_VAL_IDS)
    got = meta["train"]["cam2world"] + meta["val"]["cam2world"]
    err = max(float(np.abs(np.asarray(c)[:3] - np.asarray(views[i]["c2w"])).max())
              for c, i in zip(got, order))
    if len(meta["train"]["file_path"]) != len(train) or err > 1e-4 or \
            meta["train"]["cam_idx"] != [cams[i] for i in train]:
        raise AssertionError(f"[13a] decoded {len(meta['train']['file_path'])} training "
                             f"views, cameras off by {err}")
    log(f"[13a] street scene of {BLOCK_VIEWS} views of {WAYMO_H}x{WAYMO_W} rendered on the card "
        f"in {t1 - t0:.1f} s; TFRecords ({len(train)} training views, cameras 73 and 74, "
        f"{len(BLOCK_VAL_IDS)} val views; {sum(os.path.getsize(f) for f in files) / 1e9:.2f} GB) "
        f"written in {t2 - t1:.1f} s, decoded in {t3 - t2:.1f} s; recovered cameras within "
        f"{err:.2e} of the views'")
    return decoded, meta


def block_config(tmp: pathlib.Path, decoded: str) -> str:
    """waymo_block.py for the decoded capture: its images are named by index
    (waymo_no_block.py's training_ids, 73_<k>, select none of them), and its
    cameras are in the convention of the rays they were recovered from (x
    right, y up, -z forward), where waymo_base.py's inverse_y reads the
    OpenCV one; the run cut to FAMILY_STEPS a block, the boundaries
    compressed to CLI_PG_SCALE."""
    path = tmp / "waymo_block_cli.py"
    path.write_text(f"_base_ = {str(BLOCK_CONFIG)!r}\nbasedir = {str(tmp / 'logs')!r}\n"
                    f"data = dict(datadir={decoded!r}, training_ids=[], inverse_y=False)\n"
                    f"fine_train = dict(N_iters={FAMILY_STEPS}, pg_scale={list(CLI_PG_SCALE)})\n")
    return str(path)


def phase_waymo_blocks(tmp: pathlib.Path, card: str, shapes) -> tuple:
    """Phases 13a and 13b: waymo_block.py with ``--num_per_block`` through the
    command line on 13a's decoded records, each block at the config's full
    width; then ``--render_only`` through the merged checkpoint, and with it
    moved aside through ``run_render_blocks``. ``shapes`` (a ``PathShapes``)
    is entered around both. Returns ([the training's counts, the merged
    render's, the block render's], the decoded directory)."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch import render as render_mod
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.data import common
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    decoded, _ = street_records(tmp)
    cfg_file = block_config(tmp, decoded)
    cfg = loader.load_config(cfg_file)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    full = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    banks = 2 * full.fourier_freq_num + 1
    want_k0 = (banks, *full.world_size_rgb, full.k0_dim)
    own = loader.load_config(str(BLOCK_CONFIG))
    log(f"[13a] config {BLOCK_CONFIG.relative_to(ROOT)}: {banks} banks of {full.world_size_rgb}, "
        f"k0 {full.k0_dim} channels {full.grid_dtype}, N_rand {ft.N_rand}, sample_cam "
        f"{cfg.data.sample_cam}; cuts: {FAMILY_STEPS} steps a block of the config's "
        f"{own.fine_train.N_iters}, its boundaries {list(own.fine_train.pg_scale)} compressed to "
        f"{list(CLI_PG_SCALE)}")
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    blocks = []

    def on_block(call):
        params = call.result[2]
        blocks.append({"ids": np.asarray(call.args[1]["i_train"]).tolist(),
                       "seed": call.kwargs["seed"], "exp_dir": call.kwargs["exp_dir"],
                       "k0": (tuple(params.k0.grid.shape), params.k0.grid.dtype),
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    saves = {}  # each save's seconds by path; the spy holds no tensor alive
    with Spy(common, "load_everything") as loads, Spy(loop, "run_train", after=on_block,
                                                       keep=False), \
            Spy(ckpt, "save_model", keep=False, after=lambda c: saves.update(
                {os.path.relpath(c.args[0], exp_dir): round(c.seconds, 2)})), \
            Spy(ckpt, "merge_blocks") as merges, render_spy() as renders, shapes:
        lines = run_cli(["--config", cfg_file, "--num_per_block", str(NUM_PER_BLOCK),
                         "--i_print", "1", "--running_block_id", "0"])
    total_s = time.time() - t0
    i_train = np.asarray(loads.calls[0].result["i_train"]).tolist()
    want = [{"ids": i_train[b * NUM_PER_BLOCK:(b + 1) * NUM_PER_BLOCK], "seed": 777 + b,
             "exp_dir": os.path.join(exp_dir, f"block_{b}"), "k0": (want_k0, torch.bfloat16)}
            for b in range(2)]
    if len(i_train) != 2 * NUM_PER_BLOCK or [{k: v for k, v in b.items() if k != "peak_gb"}
                                             for b in blocks] != want:
        raise AssertionError(f"[13a] {len(i_train)} training views; blocks {blocks}, "
                             f"want {want}")
    if renders.calls or "block training finished (2 blocks)" not in lines:
        raise AssertionError("[13a] block training rendered, or did not finish")
    counts = dict(build.LAUNCHES)
    steps = 2 * FAMILY_STEPS
    want_counts = {k: v * steps for k, v in TRAIN_PER_STEP.items()}
    want_counts["masked_adam"] = adam_wanted("[13a]", steps)
    if counts != want_counts:
        raise AssertionError(f"[13a] launches {counts} != {want_counts}")
    ms = []
    for b in range(2):
        block_dir = os.path.join(exp_dir, f"block_{b}")
        records = check_family_records(f"[13a] block {b}", read_records(block_dir),
                                       "FourierGrid", full.world_size_rgb, block_dir)
        ms.append(full_width_ms(records, CLI_PG_SCALE[-1] + 1 + WARMUP_STEPS, FAMILY_STEPS))
    gb = {name: round(dir_gb(os.path.join(exp_dir, name)), 3) for name in (
        "block_0/fine_last", "block_1/fine_last", "fine_last_0", "fine_last_1",
        "fine_last_merged")}

    # the merge: the elementwise minimum, to the bit, and a fresh refresh
    t1 = time.time()
    _, mcfg, merged, step, opt = ckpt.load_model(os.path.join(exp_dir, "fine_last_merged"),
                                                 device="cuda")
    parts = [ckpt.load_model(os.path.join(exp_dir, f"fine_last_{b}"), device="cuda",
                             with_opt_state=False)[2] for b in range(2)]
    for name in ("density", "k0"):
        got = getattr(merged, name).grid
        if not torch.equal(got, torch.minimum(*(getattr(p, name).grid for p in parts))):
            raise AssertionError(f"[13a] the merged {name} is not the blocks' minimum")
    fresh = parts[0]
    for name in ("density", "k0"):
        getattr(fresh, name).grid.data = getattr(merged, name).grid.data
    fresh = fg.update_occupancy_cache(fresh, mcfg)
    mask = merged.mask_cache.mask
    if not torch.equal(mask, fresh.mask_cache.mask) or opt is not None or step != 0:
        raise AssertionError(f"[13a] the merged occupancy cache is not a fresh refresh's, or "
                             f"the merge kept an optimizer state or step {step}")
    occupancy = float(mask.float().mean())
    del merged, parts, fresh, mask
    torch.cuda.empty_cache()
    log(f"[13a] waymo_block.py --num_per_block {NUM_PER_BLOCK} on {card}: blocks of views "
        f"{[b['ids'] for b in blocks]}, seeds {[b['seed'] for b in blocks]}, k0 {want_k0} bf16; "
        f"ms/step at full width by block {[[round(t, 1) for t in m] for m in ms]}; peak memory "
        f"by block {[round(b['peak_gb'], 2) for b in blocks]} GB; saves (s) {saves}; GB on "
        f"disk {gb}; merge {merges.calls[0].seconds:.2f} s: the grids the minimum to the bit, "
        f"the occupancy cache ({occupancy:.4f} occupied) a fresh refresh's (checked in "
        f"{time.time() - t1:.1f} s); the command {total_s:.1f} s; launches {counts}")

    # ---- 13b: --render_only through the merged model, then through the blocks
    n_views = len(BLOCK_VAL_IDS) + WAYMO_TRAJECTORY
    chunks = -(-WAYMO_H * WAYMO_W // RENDER_CHUNK)
    reset_counts()
    loaded = []
    with Spy(common, "load_everything", after=cut_trajectory), \
            Spy(ckpt, "load_model", keep=False,
                after=lambda c: loaded.append(os.path.basename(c.args[0]))), \
            render_spy() as renders, shapes:
        run_cli(["--config", cfg_file, "--render_only"])
    merged_counts = dict(build.LAUNCHES)
    out = renders.calls[-1].result["test"]
    if loaded != ["fine_last_merged"] or \
            out["rgbs"].shape != (n_views, WAYMO_H, WAYMO_W, 3) or \
            len(out["psnrs"]) != len(BLOCK_VAL_IDS) or not np.isfinite(out["psnrs"]).all() or \
            merged_counts != {"march_forward": n_views * chunks}:
        raise AssertionError(f"[13b] the merged render loaded {loaded}, "
                             f"rendered {out['rgbs'].shape}, psnr {out['psnrs']}, launches "
                             f"{merged_counts}")
    log(f"[13b] --render_only through fine_last_merged: {n_views} views ({len(BLOCK_VAL_IDS)} "
        f"val with psnr {[round(x, 3) for x in out['psnrs']]}), "
        f"{[round(t * 1e3, 1) for t in out['seconds']]} ms/view; launches {merged_counts}")
    aside = os.path.join(exp_dir, "merged_aside")
    os.rename(os.path.join(exp_dir, "fine_last_merged"), aside)
    reset_counts()
    with Spy(render_mod, "run_render_blocks") as by_block, shapes:
        run_cli(["--config", cfg_file, "--render_only"])
    block_counts = dict(build.LAUNCHES)
    result = by_block.calls[0].result
    if [os.path.basename(p) for p in result["paths"]] != ["fine_last_0", "fine_last_1"] or \
            [v.tolist() for v in result["views"]] != [b["ids"] for b in blocks] or \
            block_counts != {"march_forward": len(i_train) * chunks}:
        raise AssertionError(f"[13b] run_render_blocks: {result['paths']}, views "
                             f"{result['views']}, launches {block_counts}")
    # each frame against the render of that block's checkpoint alone
    data = loads.calls[0].result
    for path, idx, got in zip(result["paths"], result["views"], result["outs"]):
        family, bcfg, params, _, _ = ckpt.load_model(path, device="cuda", with_opt_state=False)
        params.requires_grad_(False)
        cache = fg.build_render_cache(params, bcfg)
        fwd = loop.make_forward(bcfg, {"near": float(data["near"]), "far": float(data["far"]),
                                       "bg": 1.0 if cfg.data.white_bkgd else 0.0,
                                       "stepsize": fm.stepsize})
        alone = renderer.render_viewpoints(
            lambda aux, ro, rd, vd: fwd(aux[0], ro, rd, vd, None, cache=aux[1]),
            poses=np.asarray(data["poses"])[idx], HW=np.asarray(data["HW"])[idx],
            Ks=np.asarray(data["Ks"])[idx], ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
            flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y, chunk=RENDER_CHUNK,
            aux=(params, cache), verbose=False, device="cuda")
        if not np.array_equal(alone["rgbs"], got["rgbs"]):
            raise AssertionError(f"[13b] {path}: its frames differ from its render alone by "
                                 f"{np.abs(alone['rgbs'] - got['rgbs']).max()}")
        del params, cache
        torch.cuda.empty_cache()
    os.rename(aside, os.path.join(exp_dir, "fine_last_merged"))
    psnrs = [round(float(np.mean(o["psnrs"])), 3) for o in result["outs"]]
    log(f"[13b] --render_only without the merged model: run_render_blocks rendered views "
        f"{[v.tolist() for v in result['views']]} with "
        f"{[os.path.basename(p) for p in result['paths']]}"
        f" (psnr by block {psnrs}), each frame equal to its block's render alone; "
        f"{[round(t * 1e3, 1) for o in result['outs'] for t in o['seconds']]} ms/view; "
        f"launches {block_counts}")
    return [counts, merged_counts, block_counts], decoded


def phase_block_nerf(tmp: pathlib.Path, card: str, decoded: str) -> None:
    """Phases 13c and 13d: Block-NeRF at the reference's full width on 13a's
    decoded records, laid out in two overlapping blocks
    (``synthetic.write_block_nerf_scene``: ``split_blocks``), each block's
    own capture by ``extract_block_meta``; each block trained ``BN_STEPS``
    steps through ``tools.train_block_nerf`` (its fine PSNR must rise
    ``BN_MIN_GAIN`` dB); an overlap view composed through
    ``tools.eval_block_nerf``; then a chunk of ``BN_RAYS`` rays and one step's
    gradients, card against CPU within ``BN_TOL``, and the composed frame
    against the composition of the same block renders on the host."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.data import png, preprocess, synthetic
    from unboundednerfpytorch_tpu_torch.models.block_nerf import (
        compose, dataset, model as bn_model, rendering, training,
    )
    from unboundednerfpytorch_tpu_torch.tools import eval_block_nerf, train_block_nerf
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    root = str(tmp / "block_nerf_data")
    blocks = synthetic.write_block_nerf_scene(decoded, root, radius=BN_RADIUS, overlap=BN_OVERLAP)
    meta = json.load(open(os.path.join(root, "train", "train_all_meta.json")))
    members = {b: [e[0] for e in info["elements"]] for b, info in blocks.items()}
    overlap = [n for n in meta if sum(n in m for m in members.values()) > 1
               and not any(np.allclose(meta[n]["origin_pos"], info["centroid"])
                           for info in blocks.values())]
    for b in range(len(blocks)):
        unified = preprocess.extract_block_meta(root, b, str(tmp / f"block_nerf_block_{b}"))
        if len(unified["train"]["file_path"]) != len(members[f"block_{b}"]):
            raise AssertionError(f"[13c] extract_block_meta of block {b}")
    if len(blocks) != 2 or not overlap:
        raise AssertionError(f"[13c] {len(blocks)} blocks {members}, overlap views {overlap}")
    log(f"[13c] split_blocks (radius {BN_RADIUS}, overlap {BN_OVERLAP}): "
        f"{ {b: len(m) for b, m in members.items()} } views, {len(overlap)} in both and no "
        f"centroid; extract_block_meta wrote each block's capture")
    cwd = os.getcwd()
    os.chdir(tmp)  # the entry points write logs/<exp_name>/<block>, as the JAX ones
    try:
        trained = {}
        for block in blocks:
            psnr, stamps = [], []

            def on_step(call):
                psnr.append(float(call.result["psnr"]))
                stamps.append(time.perf_counter())

            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with Spy(training, "train_step", after=on_step, keep=False):
                if train_block_nerf.main(["--root_dir", root, "--block_index", block,
                                          "--steps", str(BN_STEPS)]) != 0:
                    raise AssertionError(f"[13c] train_block_nerf {block}")
            w = BN_PSNR_WINDOW
            gain = float(np.mean(psnr[-w:]) - np.mean(psnr[:w]))
            step_ms = float(np.median(np.diff(stamps[w:]))) * 1e3
            trained[block] = dict(gain=round(gain, 3), first=round(float(np.mean(psnr[:w])), 3),
                                  last=round(float(np.mean(psnr[-w:])), 3),
                                  step_ms=round(step_ms, 2), seconds=round(time.time() - t0, 1),
                                  peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2))
            if len(psnr) != BN_STEPS or not gain >= BN_MIN_GAIN:
                raise AssertionError(f"[13c] {block}: {len(psnr)} steps, psnr rose {gain} dB")
        log(f"[13c] Block-NeRF (D=8, W=256, vis 128, appearance 32, 64 + 64 samples, batch "
            f"1024, use_disp) on {card}: {BN_STEPS} steps a block through train_block_nerf: "
            f"{trained}")
        view = overlap[0]
        out = str(tmp / "block_nerf_compose")
        t0 = time.time()
        with Spy(compose, "render_block") as renders:
            if eval_block_nerf.main(["--root_dir", root, "--ckpt_dir", "logs/block_nerf",
                                     "--out_dir", out, "--cam_begin", view,
                                     "--cam_end", view]) != 0:
                raise AssertionError("[13c] eval_block_nerf")
        compose_s = time.time() - t0
        frame = png.imread(os.path.join(out, f"{view}.png"))
    finally:
        os.chdir(cwd)
    H, W = WAYMO_H // 4, WAYMO_W // 4
    video = [n for n in os.listdir(out) if n.startswith("compose")]
    if frame.shape != (H, W, 3) or len(renders.calls) != 2 or not video:
        raise AssertionError(f"[13c] composed {frame.shape} from {len(renders.calls)} blocks, "
                             f"{os.listdir(out)}")
    # 13d: the frame against the host's composition of the same block renders
    candidates = [b for b in blocks if view in members[b]]
    vis = {b: round(float(c.result["transmittance_fine_vis"].mean()), 4)
           for b, c in zip(candidates, renders.calls)}
    rays, _, _, _ = dataset.build_image_rays(meta[view], None, 0)
    kept = {}
    for block, call in zip(candidates, renders.calls):
        if vis[block] > compose.VISIBILITY_GATE:
            kept[block] = {**call.result, "distance_weight": compose.distance_weight(
                rays[0, :3], blocks[block]["centroid"])}
    rgb, _ = compose.inverse_interpolation(kept, H, W)
    if not kept or not np.array_equal(rgb["compose"], frame):
        raise AssertionError(f"[13d] the composed frame is not the blocks' composition ({kept})")
    log(f"[13c] eval_block_nerf composed view {view} ({H}x{W}) from {sorted(kept)} (mean "
        f"fine visibility by block {vis}) in {compose_s:.1f} s, "
        f"{[round(c.seconds * 1e3, 1) for c in renders.calls]} ms a block render; frames "
        f"{video}; [13d] the frame equals the host's blend of the same renders")

    # ---- 13d: the card against the CPU on block_0's trained model. The fine
    # depths invert the cdf of the coarse weights at 65 fixed u, and a bin
    # whose cdf step is under sample_pdf's alpha takes a step of 1: where the
    # two devices' cdfs (some 1e-7 apart) straddle a u there, that fine depth
    # jumps to another bin. Such rays are counted and bounded
    # (BN_MAX_FLIPPED of the rays), the others held within BN_TOL, and the
    # gradients taken on a batch without them.
    model, _ = ckpt.load_block_nerf(os.path.join(tmp, "logs", "block_nerf", "block_0"), "cuda")
    cpu_model, _ = ckpt.load_block_nerf(os.path.join(tmp, "logs", "block_nerf", "block_0"))
    store, _ = dataset.load_block_ray_store(root, "block_0")
    kw = dict(n_samples=64, n_importance=64, use_disp=True)

    def render(m, rays, ts, jitter=None):
        with Spy(rendering, "sample_pdf") as pdf:
            out = rendering.render_rays(m, rays, ts, jitter=jitter, **kw)
        return out, pdf.calls[0].result.detach().cpu()

    def flipped(z_card, z_cpu):
        return ((z_card - z_cpu).abs() > 1e-4 * z_cpu.abs() + 1e-6).any(-1)

    t0 = time.time()
    rays = torch.as_tensor(store["rays"][:BN_RAYS])
    ts = torch.as_tensor(store["ts"][:BN_RAYS])
    with torch.no_grad():
        got, z_card = render(model, rays.to("cuda"), ts.to("cuda"))
        ref, z_cpu = render(cpu_model, rays, ts)
    flips = flipped(z_card, z_cpu)
    keep = ~flips
    errs = {k: float((got[k].cpu()[keep] - r[keep]).abs().max() / r.abs().max().clamp(min=1e-30))
            for k, r in ref.items()}
    sel = torch.randint(0, len(store["rays"]), (1024,), generator=torch.Generator().manual_seed(0))
    jitter = torch.rand((1024, 65), generator=torch.Generator().manual_seed(1))
    batch = {k: torch.as_tensor(v)[sel] for k, v in store.items()}
    with torch.no_grad():
        batch_flips = flipped(render(model, batch["rays"].to("cuda"), batch["ts"].to("cuda"),
                                     jitter.to("cuda"))[1],
                              render(cpu_model, batch["rays"], batch["ts"], jitter)[1])
    batch = {k: v[~batch_flips] for k, v in batch.items()}
    grads = []
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        res = rendering.render_rays(m, batch["rays"].to(dev), batch["ts"].to(dev),
                                    jitter=jitter[~batch_flips].to(dev), **kw)
        m.zero_grad(set_to_none=True)
        sum(bn_model.block_nerf_loss(res, batch["rgbs"].to(dev)).values()).backward()
        grads.append({n: p.grad.detach().cpu() for n, p in m.named_parameters()})
    for n, g in grads[1].items():
        errs[f"grad {n}"] = float((grads[0][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
    worst = max(errs, key=errs.get)
    n_flips, n_batch_flips = int(flips.sum()), int(batch_flips.sum())
    log(f"[13d] card against CPU, block_0: a chunk of {BN_RAYS} rays and a step's gradients of "
        f"1024 rays in {time.time() - t0:.1f} s; fine depths in another bin on {n_flips} rays of "
        f"the chunk and {n_batch_flips} of the batch (at most {BN_MAX_FLIPPED:.0%}); on the "
        f"others the largest error over the largest value {errs[worst]:.2e} ({worst}), "
        f"tolerance {BN_TOL:g}; outputs "
        f"{ {k: f'{v:.1e}' for k, v in errs.items() if not k.startswith('grad')} }")
    if errs[worst] > BN_TOL or n_flips > BN_MAX_FLIPPED * BN_RAYS or \
            n_batch_flips > BN_MAX_FLIPPED * 1024:
        raise AssertionError(f"[13d] {worst}: {errs[worst]} > {BN_TOL}, or {n_flips} and "
                             f"{n_batch_flips} rays with fine depths in another bin")


def phase_block_kernels(gen, kernels: list, shapes, floor: float, seen: set,
                        held_tv: set) -> None:
    """Phase 13e: both march kernels and masked Adam at every shape 13a and
    13b gave them (``phase_dvgo_kernels``), and ``tv_add_grad`` at each grid
    shape of 13a's steps that phase 3 did not hold (``held_tv``: the
    full-width ones are waymo_no_block.py's), checked, then timed as the
    train step calls it (in place, dense)."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms, time_ms

    rows = {k["name"]: k for k in kernels}
    phase_dvgo_kernels(gen, kernels, {"13a,b waymo_block.py": shapes}, floor, (), seen)
    if not shapes.tv:
        raise AssertionError("[13e] the block training launched no tv_add_grad")
    for (shape, dtype, w), n in sorted(shapes.tv.items(), key=str):
        if (shape, dtype) in held_tv:
            continue
        held_tv.add((shape, dtype))
        label = f"13a ({n} calls)"
        err = tv_case(gen, label, shape, dtype, w)
        rows["tv_add_grad"]["max_abs_err"] = max(rows["tv_add_grad"]["max_abs_err"], err)
        p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        ms, call = kernel_ms(lambda: tv.tv_add_grad(p, g, *w, 1.0, True, out=g))
        line = shape_line(f"tv_add_grad {label} {shape} {str(dtype)[6:]} in place", ms, call,
                          bound_ms(3 * p.numel() * p.element_size(), 25 * p.numel())[0], floor)
        line["plain_ms"] = time_ms(lambda: tv.tv_add_grad_plain(p, g, *w, 1.0, True), iters=5)
        rows["tv_add_grad"]["shapes"].append(line)
        del p, g
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_distributed(exp_dir: str, data, cfg, cfg_file: str, card: str) -> list:
    """Phase 14a: the distributed code at world size 1 over a real NCCL group
    (opened in this process on a localhost TCP store). Phase 4's model
    (``load_phase5``) takes one ``DIST_N_RAND`` batch through the train step
    without a mesh and through the data-parallel step over the group's mesh
    (the optimizer replaced by ``GradGrab``, TV on): the loss equal, every
    gradient by ``check_grad``; then the first test view renders through
    phase 5's render cache without a mesh and cooperatively over the group:
    equal within 1e-6. Returns the launch counts of the data-parallel step and
    of the cooperative render."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
    from unboundednerfpytorch_tpu_torch.render.renderer import render_image
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.train.step import TrainState, make_train_step

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.make_mesh()
        mcfg, params = load_phase5(exp_dir)
        params.requires_grad_(True)
        ft = cfg.fine_train
        store = loop.gather_training_rays(cfg, data, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(14)
        idx = torch.randint(store["rgb"].shape[0], (DIST_N_RAND,), generator=gen, device="cuda")
        batch = {k: v[idx] for k, v in store.items()}
        del store
        kw = {"near": float(data["near"]), "far": float(data["far"]), "bg": 0.0,
              "rand_bkgd": False, "stepsize": cfg.fine_model_and_render.stepsize}
        near_thres = 0.0
        if ft.weight_nearclip > 0 and data.get("near_clip"):
            near_thres = float(data["near_clip"]) / float(mcfg.scene_radius[0])
        out, counts = {}, []
        for tag, m in (("single", None), ("distributed", mesh)):
            reset_counts()
            step_fn = make_train_step(loop.make_forward(mcfg, kw), ft,
                                      world_size_max=float(max(mcfg.world_size)),
                                      near_thres=near_thres, lr_anchor=1, mesh=m)
            grab = GradGrab(params)
            metrics = step_fn(TrainState(params, grab, step=100), batch)
            torch.cuda.synchronize()
            out[tag] = ({k: float(v) for k, v in metrics.items()}, grab.grads)
            counts.append(dict(build.LAUNCHES))
        (m1, g1), (m2, g2) = out["single"], out["distributed"]
        want = {"tv_add_grad": 2, "march_forward": 1, "march_backward": 1}
        if counts[1] != want or m1["loss"] != m2["loss"] or m1["psnr"] != m2["psnr"]:
            raise AssertionError(f"[14a] the data-parallel step: loss {m2['loss']} against "
                                 f"{m1['loss']}, launches {counts[1]} != {want}")
        for k in set(g2) - set(g1):  # the collective gives every parameter a grad
            if bool(g2[k].any()):
                raise AssertionError(f"[14a] {k}: a gradient where the step has none")
        grads = {k: check_grad(k, g2[k], g1[k], tag="[14a]") for k in g1}
        del out, g1, g2, batch
        params.requires_grad_(False)
        cache = fg.build_render_cache(params, mcfg)
        fwd = loop.make_forward(mcfg, {**kw, "bg": 1.0 if cfg.data.white_bkgd else 0.0})
        view = int(np.asarray(data["i_test"])[0])
        H, W = (int(v) for v in np.asarray(data["HW"])[view])
        args = (H, W, np.asarray(data["Ks"])[view], np.asarray(data["poses"])[view][:3, :4])
        renders = []
        for m in (None, mesh):
            reset_counts()
            t0 = time.perf_counter()
            renders.append(render_image(lambda ro, rd, vd: fwd(params, ro, rd, vd, None,
                                                               cache=cache), *args,
                                        inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
                                        flip_y=cfg.data.flip_y, device="cuda", mesh=m))
            renders[-1] = (*renders[-1], (time.perf_counter() - t0) * 1e3)
        counts.append(dict(build.LAUNCHES))
        if set(counts[-1]) != {"march_forward"}:
            raise AssertionError(f"[14a] the cooperative render launched {counts[-1]}")
        diffs = [float(np.abs(a - b).max()) for a, b in zip(renders[0][:3], renders[1][:3])]
        if max(diffs) > 1e-6:
            raise AssertionError(f"[14a] the cooperative render differs by {diffs}")
        log(json.dumps({"phase": "14a", "card": card, "world_size": dist.get_world_size(),
                        "backend": dist.get_backend(), "n_rand": DIST_N_RAND,
                        "loss": m2["loss"], "psnr": m2["psnr"], "grads": grads,
                        "render_max_abs_diff": diffs, "render_ms": [renders[0][3],
                                                                    renders[1][3]],
                        "launches": counts}))
        del params, cache
        return counts[1:]
    finally:
        dist.destroy_process_group()


def halo_sample_case(gen, shape, ways: int) -> dict:
    """14b's sample: an f32 grid of ``shape`` cut into ``ways`` x-slabs, each
    extended by a copy of its right neighbour's first plane (zeros for the
    last), every shard's ``halo.partial_sample`` of the same queries summed
    against the unsharded ``grid_sample_banks``, and the gradients of a
    weighted sum, each shard's appended plane's added to its neighbour's
    first plane as the exchange's backward does, joined, against the
    unsharded gradient."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops import interp
    from unboundednerfpytorch_tpu_torch.parallel import halo

    B, X = shape[0], shape[1]
    xs = X // ways
    grid = torch.randn(shape, generator=gen, device="cuda")
    # queries in and a little beyond the box, a share exactly on the slab edges
    c01 = torch.rand((HALO_QUERIES, B, 3), generator=gen, device="cuda") * 1.1 - 0.05
    n_edge = HALO_QUERIES // 8
    edge = torch.randint(1, ways, (n_edge, B), generator=gen, device="cuda") * xs
    edge -= torch.randint(0, 2, (n_edge, B), generator=gen, device="cuda")  # or the plane before
    c01[:n_edge, :, 0] = edge.float() / (X - 1)
    cot = torch.randn((HALO_QUERIES, shape[-1]), generator=gen, device="cuda")
    whole = grid.clone().requires_grad_(True)
    want = interp.grid_sample_banks(whole, c01)
    (want * cot).sum().backward()
    total, exts = None, []
    for k in range(ways):
        slab = grid[:, k * xs:(k + 1) * xs]
        nxt = grid[:, (k + 1) * xs] if k + 1 < ways else torch.zeros_like(grid[:, 0])
        ext = torch.cat([slab, nxt[:, None]], dim=1).requires_grad_(True)
        part = halo.partial_sample(ext, c01, k, X)
        (part * cot).sum().backward()
        total = part.detach() if total is None else total + part.detach()
        exts.append(ext.grad)
    joined = torch.cat([e[:, :xs] for e in exts], dim=1)
    for k in range(ways - 1):
        joined[:, (k + 1) * xs] += exts[k][:, xs]
    want = want.detach()
    big = float(want.abs().max())
    err = float((total - want).abs().max())
    if not err <= 1e-6 * big:
        raise AssertionError(f"[14b] the halo sample of {shape} over {ways}: {err} of {big}")
    return {"values_max_abs_err": err, "values_max_abs": big,
            "grad": check_grad(f"halo {shape}/{ways}", joined, whole.grad, tag="[14b]")}


def phase_halo(gen, kernels: list, shapes, floor: float, card: str) -> None:
    """Phase 14b: at each grid shape 13a's steps gave ``tv_add_grad`` whose X
    ``HALO_WAYS`` cuts, the halo sample (``halo_sample_case``) and the TV of
    each x-slab with its neighbours' boundary planes through the kernel's
    halo launch: against the plain version of the same slab and planes, and
    the slabs' results, joined, equal to the whole grid's launch to the bit,
    sparse and dense. The halo launch of a middle slab is timed (in place,
    dense, as the train step calls it) and its line joins ``tv_add_grad``'s
    shapes; these launches are comparisons, so they count on no path."""
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, kernel_ms, time_ms

    row = {k["name"]: k for k in kernels}["tv_add_grad"]
    cases = sorted({(shape, dtype, w) for shape, dtype, w in shapes.tv
                    if shape[1] in HALO_WAYS}, key=str)
    if {shape[1] for shape, _, _ in cases} != set(HALO_WAYS):
        raise AssertionError(f"[14b] 13a gave no grid of X in {sorted(HALO_WAYS)}: {cases}")
    samples = {}
    for shape, dtype, w in cases:
        ways = HALO_WAYS[shape[1]]
        xs = shape[1] // ways
        samples[f"{shape}/{ways}"] = halo_sample_case(gen, shape, ways)
        torch.cuda.empty_cache()
        p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda")
        g = (g * (torch.rand(shape, generator=gen, device="cuda") > 0.4)).to(dtype)
        slabs = []
        for k in range(ways):
            lo = p[:, k * xs - 1].contiguous() if k > 0 else None
            hi = p[:, (k + 1) * xs].contiguous() if k + 1 < ways else None
            slabs.append((p[:, k * xs:(k + 1) * xs].contiguous(),
                          g[:, k * xs:(k + 1) * xs].contiguous(), lo, hi))
        for dense in (False, True):
            whole = tv.tv_add_grad(p, g, *w, 1.0, dense)
            parts = []
            for k, (ps, gs, lo, hi) in enumerate(slabs):
                got = tv.tv_add_grad(ps, gs, *w, 1.0, dense, lo=lo, hi=hi)
                ref = tv.tv_add_grad_plain(ps.float(), gs.float(), *w, 1.0, dense,
                                           lo=None if lo is None else lo.float(),
                                           hi=None if hi is None else hi.float())
                torch.cuda.synchronize()
                row["max_abs_err"] = max(row["max_abs_err"], check_each(
                    f"tv halo {tuple(shape)} slab {k}/{ways} dense={dense}", got, ref, 1e-5,
                    1e-6))
                parts.append(got)
                del ref
            if not torch.equal(torch.cat(parts, dim=1), whole):
                raise AssertionError(f"[14b] the slabs' TV of {shape} over {ways}, joined, is "
                                     f"not the whole grid's (dense={dense})")
            del whole, parts
        ps, gs, lo, hi = slabs[1 if ways > 2 else 0]
        lo = lo if lo is not None else hi
        ms, call = kernel_ms(lambda: tv.tv_add_grad(ps, gs, *w, 1.0, True, out=gs, lo=lo, hi=hi))
        # param, grad and out of the slab, and the two planes read
        nbytes = (3 * ps.numel() + 2 * lo.numel()) * ps.element_size()
        line = shape_line(f"[14b] tv_add_grad halo launch, slab {tuple(ps.shape)} of "
                          f"{tuple(shape)} over {ways} {str(dtype)[6:]} in place", ms, call,
                          bound_ms(nbytes, 25 * ps.numel())[0], floor)
        line["plain_ms"] = time_ms(lambda: tv.tv_add_grad_plain(ps, gs, *w, 1.0, True, lo=lo,
                                                                hi=hi), iters=5)
        line["halo"] = True
        row["shapes"].append(line)
        del p, g, slabs, ps, gs, lo, hi
        torch.cuda.empty_cache()
    log(json.dumps({"phase": "14b", "card": card, "sample": samples,
                    "tv_halo_shapes": [str(c[0]) for c in cases]}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help=f"trace the last {PROFILED_STEPS} train steps and one rendered view "
                         "with torch.profiler")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3: the kernel table without launch counts (nor "
                         "times of masked_adam_per_lr, which phase 9c times at the DVGO "
                         "runs' shapes), and no ok line")
    args = ap.parse_args(argv)
    least = PG_SCALE[-1] + WARMUP_STEPS + 1 + (PROFILED_STEPS if args.profile else 0)
    if args.steps < least:
        ap.error(f"--steps must be at least {least}: the last boundary is at step "
                 f"{PG_SCALE[-1]}, and full-width steps are timed after it")
    if args.views < 9:
        ap.error("--views must be at least 9: every 8th view is held out, and a render is "
                 "timed after a warm-up view")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "unboundednerfpytorch_tpu_torch").is_dir() or not CONFIG.is_file():
        print(f"chip_smoke: the repository is not beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # float32 products in full precision, as the CPU reference runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam
    from unboundednerfpytorch_tpu_torch.probes.timing import MANY_LAUNCHES, launch_floor_ms

    t_start = time.time()
    card = phase_device()
    phase_build()
    cfg = slice_config(args.steps)
    tv_shapes, march_shape, shift, interval = slice_shapes(cfg)
    truck_tv, truck_march, *_ = slice_shapes(loader.load_config(str(TRUCK_CONFIG)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    floor = launch_floor_ms()
    log(f"[3] launch floor: an empty <<<1, 32>>> kernel takes {floor:.5f} ms a launch "
        f"({MANY_LAUNCHES} launches in one CUDA graph between one pair of events)")
    seconds, written = {}, {}
    written_start = written_gib()

    def timed(phase, fn, *fn_args):
        t0, w0 = time.time(), written_gib()
        out = fn(*fn_args)
        torch.cuda.empty_cache()
        seconds[phase] = time.time() - t0
        if w0 is not None:
            written[phase] = written_gib() - w0
        return out

    seconds["1-2"] = time.time() - t_start
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        log(f"[3] temporary directory {tmp}: "
            f"{os.statvfs(tmp).f_bavail * os.statvfs(tmp).f_frsize / 1e9:.1f} GB free")
        # 7b's capture gives the DMPIGO grid that phase 3 holds the kernels at
        fern_file, fern_box = timed("7b scene", fern_scene, tmp)
        fam = family_shapes(fern_box)
        t0 = time.time()
        kernels = [phase_tv(gen, tv_shapes, floor, truck_tv)]
        kernels += phase_march(gen, march_shape, shift, interval, floor, truck_march)
        err, lines = phase_tv_families(gen, fam, floor)
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], err)
        kernels[0]["shapes"] += lines
        err_f, err_b, f_lines, b_lines = phase_march_families(gen, fam, floor)
        for k, err, lines in ((kernels[1], err_f, f_lines), (kernels[2], err_b, b_lines)):
            k["max_abs_err"] = max(k["max_abs_err"], err)
            k["shapes"] += lines
        kernels.append(phase_cumdist(gen, fam, floor))
        kernels += phase_adam(gen, tv_shapes, fam, floor)
        probe_kernels, probe_counts = phase_probes(floor)
        kernels += probe_kernels
        torch.cuda.empty_cache()
        seconds["3"] = time.time() - t0
        if args.kernels_only:
            log(f"card: {card}")
            log(json.dumps({"kernels": kernels}))
            return 0

        cfg_file, data = timed("4 scene", phase_scene, tmp, args.views)
        exp_dir = str(tmp / "api")
        # every optimizer step of phases 4 to 9 counts the launches it should make
        with Spy(MaskedAdam, "step", before=ADAM_WANTED, keep=False):
            path_counts = [timed("4", phase_train, cfg, args.steps, data, args.profile,
                                 exp_dir, card, tv_shapes)]
            timed("4b", phase_boundary, cfg, card)
            style = tmp / "style" / "0.jpg"
            style_image(style)
            path_counts.append(timed("5", phase_render, cfg, data, exp_dir, cfg_file,
                                     args.profile, style))
            path_counts += timed("6a", phase_cli_360, cfg_file, card, len(data["i_test"]))
            path_counts += timed("6b", phase_cli_truck, tmp, card)
            path_counts += timed("7a", phase_cli_dcvgo, tmp, card)
            path_counts += timed("7b", phase_cli_fern, fern_file, card)
            path_counts += timed("7c", phase_host_store, tmp, card)
            path_counts += timed("8a", phase_cli_waymo, tmp, card)
            path_counts += timed("8b", phase_free, tmp, card)
            lego_file = timed("9a scene", lego_scene, tmp)
            # phase 9c holds the kernels at the shapes these runs give them
            with PathShapes() as lego_shapes:
                path_counts += timed("9a", phase_cli_lego, lego_file, card)
            with PathShapes() as truck_lg_shapes:
                path_counts += timed("9b", phase_truck_lg, tmp, card)
            # phase 10f holds the kernels at the shapes these runs give them
            phase10 = {}
            path_counts += timed("10a", phase_cli_linemod, tmp, card, phase10)
            path_counts += timed("10b", phase_co3d, tmp, card, phase10)
            path_counts += timed("10c", phase_ship, tmp, card, lego_file, phase10)
            path_counts += timed("10d", phase_madoka, tmp, card, phase10)
            path_counts += timed("10e", phase_tune_pose, tmp, card, phase10)
            # phase 11: reference .tar checkpoints, 9a's panel and the
            # server (11g is phase 5's render); 11h holds the kernels at the
            # shapes 11a and 11c give
            phase11 = {}
            path_counts += timed("11a,e", phase_tar_cli, tmp, card, lego_file, phase11)
            path_counts += timed("11b", phase_tar_in_memory, exp_dir, data, cfg, card)
            path_counts += timed("11c", phase_tar_tune, tmp, card, phase11)
            path_counts += timed("11f", phase_serve, tmp, card, lego_file)
            # phase 12: the fast paths; 12f holds the kernels at their shapes
            shapes12 = PathShapes()
            path_counts += timed("12", phase_fast_paths, exp_dir, data, cfg, cfg_file, card,
                                 tv_shapes, shapes12)
            # phase 13: the Waymo city-scale path; 13e holds the kernels at
            # the shapes 13a and 13b gave them
            shapes13 = PathShapes()
            counts13, decoded = timed("13a,b", phase_waymo_blocks, tmp, card, shapes13)
            path_counts += counts13
            timed("13c,d", phase_block_nerf, tmp, card, decoded)
            # phase 14: multi-device parallelism on one card (14b below)
            path_counts += timed("14a", phase_distributed, exp_dir, data, cfg, cfg_file, card)
    # phase 3 held masked Adam at phase 4's grids already
    seen = {(tuple(s), torch.bfloat16, True, True, False) for s in tv_shapes.values()}
    timed("9c", phase_dvgo_kernels, gen, kernels,
          {"9a lego.py": lego_shapes, "9b Truck_lg.py": truck_lg_shapes}, floor,
          ("9a lego.py", "9b Truck_lg.py"), seen)
    timed("10f", phase_dvgo_kernels, gen, kernels, phase10, floor, ("10b teddybear.py",), seen)
    timed("11h", phase_dvgo_kernels, gen, kernels, phase11, floor, (), seen)
    timed("12f", phase_fast_kernels, gen, kernels, shapes12, floor, seen,
          (1, *tv_shapes["k0"][1:4], 3))
    timed("13e", phase_block_kernels, gen, kernels, shapes13, floor, seen,
          {(tuple(shape), dtype) for _, shape, dtype, _ in fam["tv"]})
    timed("14b", phase_halo, gen, kernels, shapes13, floor, card)
    log(f"seconds by phase: { {k: round(v, 1) for k, v in seconds.items()} }, in all "
        f"{time.time() - t_start:.1f}")
    if written:
        log(f"GiB written by phase (the process's write calls, /proc/self/io wchar): "
            f"{ {k: round(v, 3) for k, v in written.items() if v >= 0.001} }, in all "
            f"{written_gib() - written_start:.2f}")
    # a kernel's launches: those of every path that ran it, each path counted
    # from 0 just before it was driven to just after
    for k in kernels:
        k["launches"] = sum(c.get(k["name"], 0) for c in path_counts + [probe_counts])
        if k["launches"] < 1 or any(k[key] is None for key in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"no path launched {k['name']}, or it was not timed")
    log(f"launches by path: train {path_counts[0]}, render {path_counts[1]}, 6a run 1 train "
        f"and render {path_counts[2:4]}, run 2 {path_counts[4:6]}, 6b {path_counts[6:8]}, "
        f"7a DCVGO train and render {path_counts[8:10]}, 7b DMPIGO {path_counts[10:12]}, "
        f"7c host store train {path_counts[12]}, 8a waymo train and render "
        f"{path_counts[13:15]}, 8b free {path_counts[15:17]}, 9a DVGO lego train and render "
        f"{path_counts[17:19]}, 9b Truck_lg train {path_counts[19]}, 10a linemod train and "
        f"render {path_counts[20:22]}, 10b co3d {path_counts[22:24]}, 10c ship.tensorf "
        f"{path_counts[24:26]}, 10d Madoka train {path_counts[26]}, 10e tune_pose, the "
        f"recovery's model and the recovery {path_counts[27:30]}, 11a the .tar's render, "
        f"train and render {path_counts[30:33]}, 11b {path_counts[33]}, 11c "
        f"{path_counts[34]}, 11f {path_counts[35]}, 12a, 12d and the layout "
        f"{path_counts[36:39]}, 12c {path_counts[39]}, 12b single and two-stage "
        f"{path_counts[40:42]}, 12e coarse head, view grid and embeddings "
        f"{path_counts[42:45]}, 13a block training {path_counts[45]}, 13b the merged and the "
        f"block renders {path_counts[46:48]}, 14a the data-parallel step and the cooperative "
        f"render {path_counts[48:50]}, probes {probe_counts}")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
