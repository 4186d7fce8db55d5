#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deep_cartograph_torch) on one CUDA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

With several cards, `python3 chip_smoke.py --multi-gpu` runs phases 1 and
3 (on the first card alone) and phase 11 over every card, and prints no
kernels line.

Phases, each failing the run (non-zero exit) if it fails:

1. Device and build: requires CUDA, prints the card's name and power limit
   (nvidia-smi), builds every kernel from ops/csrc with nvcc in parallel,
   then the host C++ libraries (io/csrc, stats/csrc) with g++ in parallel.
2. Kernels against their plain PyTorch versions at the main path's shapes:
   K1 (pair distances) on one featurize chunk (the 20,000 frames asked for,
   clamped by auto_chunk_size to 13,899) of 48 CA atoms x 1,081 pairs,
   K2 (KDE logsumexp) on a 150 x 150 grid x 100,000 samples (and again on
   that grid stretched 2.5-fold, every corner far from every sample, with
   the samples sorted by distance from a corner, farthest first), K3 (all-pairs
   distance matrix, no caller on the main path) on 256 frames x 1,000
   atoms. Each is timed with CUDA events beside its plain version, one
   PyTorch library call computing the same function, and its bound on this
   card.
3. Main path at the shape of the repo's headline workload (BASELINE.md
   config 2, bench.py:47-53 and :342-430): write a 100,000-frame x 48-atom
   DCD and its CA PDB, featurize it (1,171 features, K1), compute the filter
   statistics on the card (entropy, std), keep the features whose rounded
   std is not below its median, train a deep-TICA CV on them (net
   (d_in, 64, 64, 2), tanh, lag 10, 10 seeded tries as one batched
   program, batch 4,096, 10 epochs, Adam 1e-3), fit its TICA layer and
   post-normalization, serve the trained CV over every frame with
   FramesToCV (K1) and draw the 1-D FES of each CV (dense branch) and the
   2-D FES (K2 branch). The kernels' launch counters are zeroed just before
   and read just after, and the outputs are checked against numpy
   references on a small input. The 2-D FES is then timed 5 times more.
4. The CV calculators' file surface on the main path's data, the kernels'
   counters zeroed before and read after (`cv_surface`): PCA, TICA and
   HTICA trained on the 100,000 x 586 device matrix; a PLUMED colvars file
   of time + the 1,171 features (20,000 frames: the depth cut keeps the
   text near 210 MB) written and read back; the Filter on it; streaming
   TICA (on-card Krylov solver) and HTICA from it against the in-memory
   calculators; the deep-TICA and linear CVs saved as model.zip, loaded
   back and projecting the file; FramesToCV.from_model_zip serving every
   frame of the DCD (K1); the linear CVs on the card against the CPU on
   5,000 frames.
5. Training on the card against the same training by the port on the CPU,
   on a cut-down copy (20,000 frames, 2 tries, 2 epochs); then the main
   path's training cut to 2 epochs, through the calculator, once under
   torch's sync debug mode (host syncs by line of code) and once under
   torch.profiler (per step: host time, card time, sync calls).
6. The autoencoders and the PLUMED files on the main path's data, the
   kernels' counters zeroed before and read after (`autoencoders`): an AE
   and a VAE (the schema's default encoder (586, 64, 32, 16, 2),
   leaky_relu, the mirrored decoder; the main path's 10 tries, batch 4,096,
   10 epochs, Adam 1e-3; the VAE through its default sigmoid KL annealing
   to the post-annealing checkpoint) trained as one batched program each,
   then 2 epochs of each again under sync debug mode and torch.profiler;
   an AE with batchnorm after every hidden layer (2 epochs), its fold
   against the unfolded net on the whole training set; the three saved as
   model.zip, loaded back and served by FramesToCV.from_model_zip from the
   DCD (K1); write_plumed_files for PCA, TICA, HTICA (phase 4), deep-TICA
   (phase 3), AE and VAE with the default opes_metad bias, and once with
   the RMSD restraint on the first and last frames as waypoints: each
   TorchScript `*_weights.pt` run on the card, each linear input's COMBINE
   chain evaluated on the feature matrix, both against the projection; the
   AE on the card against the CPU on 5,000 frames for 2 epochs, with
   leaky_relu (its projection held to the card's own one-ulp spread over
   6 seeds of input noise) and again with tanh.
7. Trajectory inputs and clustering (traj_cluster) on the main path's data,
   the kernels' counters zeroed before and read after
   (`inputs_and_clustering`): the 100,000 frames written as XTC by the
   port's codec, counted, decoded and featurized (K1) and held to numpy, and
   split into three trajectories of uneven length featurized through shared
   chunks, equal to the single one; the main path's projected deep-TICA
   values (100,000 x 2) clustered with the schema's settings: the k-means
   scan (k = 3..10, n_init 20; host reads of one Lloyd run by line of
   code), its labels warm-started on the CPU from the card's centroids,
   find_centroids, the scores (held to float64 numpy on a 10,000-row cut),
   HDBSCAN (min_cluster_size 5, min_samples 3, eom; the card against the
   port's CPU path on a 20,000-row cut; on a 40,000-row cut with its core
   distances and Prim's tree timed), the complete-linkage hierarchical scan
   on a 5,000-row cut, and the XTC trajectory's projection assigned to its
   nearest clustered frames (100,000 against 100,000; 1,000 rows held to
   float64 numpy).
8. Geometry analysis and UMAP on the main path's data, the kernels'
   counters zeroed before and read after (`geometry`): RMSD (its first and
   second call timed, and the first batched SVD of a fresh process), RMSF
   and dRMSD (K1) of the 100,000-frame DCD against its first frame, held on
   every 50th frame to float64 numpy and to the port on the CPU; the
   trajectory augmented to 150,000 frames by pchip and by akima as XTC,
   held to scipy; hydrogen bonds of a 50-residue backbone peptide over
   50,000 frames (150 MB of coordinates), held to a float64 numpy mask on
   every 50th frame; the Müller-Brown sampler at its defaults (50,000
   steps), its first 1,000 steps held to float64 numpy with the same noise;
   the UMAP CV at 100,000 x 586 (the schema's defaults, mean_std, 300
   epochs): the fit's parts, transform, save, load and project_colvars of
   phase 4's file timed, the kNN of 1,000 rows held to float64 numpy
   within the float32 error bound of its d2 expansion (at 100,000 rows and
   again on the first 50,000),
   sigma to its equation, one layout epoch card against CPU, a fit on
   5,000 rows card against CPU beside its one-ulp spread, and
   FramesToCV.from_model_zip refusing the zip.
9. The pipeline through its command line, the kernels' counters zeroed
   before and read after (`pipeline`): `cli.main()` in this process with a
   user's command line (deep_carto_torch -conf <json> ...; JSON, since the
   card machine may lack PyYAML) on the main path's trajectory at full
   width: the first 20,000 frames as training data, every 200th frame of
   the next 20,000 as seed data (augmented to 1,000 frames, pchip, XTC),
   the next 5,000 as supplementary data; RMSD, RMSF and dRMSD (K1);
   1,171 features (K1), the std-median screen, all seven CVs (deep-TICA as
   on the main path; AE and VAE with the schema's encoder; dimension 2,
   lag 10), the supplementary projection, and the k-means scan (k = 3..10,
   n_init 20) with centroids, figures off. The colvars are held to float64
   numpy on every 50th frame, the kept features to phase 3's screen, every
   projected CSV to its model.zip's projection, the cluster CSVs to the
   JAX column order (one centroid per cluster, k in [3, 10]) and the
   supplementary clusters to a float64 nearest-neighbour search; the step
   times are the tools' own "Elapsed time" records.
10. The native host I/O and transport, the kernels' counters zeroed before
   and read after (`native_io`): the main path's DCD (read, like phase 3's,
   by the prefetching native reader) featurized again with int16 upload
   (quantized on the host, dequantized on the card, K1), held to phase 3's
   float32 features within the bound the quantization step implies (a
   dihedral's sin/cos whose bound is 1 or more is counted, not held); phase
   4's colvars file (20,000 frames x 1,172) written by the native formatter
   and read by the native parser with the memory cache on (MB/s; its first
   2,000 rows byte-equal to the Python writer's, a cold read equal to the
   cached one); the batch dip test over the 586 kept features (16 of them
   held to the Python dip); the streaming HTICA at phase 4's shape (20,000
   frames, 580 features) by fit, fit_fused and fit_chunked on blocks
   featurized through K1 from coordinates on the card (the fused and
   chunked passes replay CUDA graphs), held to each other within 1e-5; the
   calpha_transitions demo dataset materialized and one system featurized;
   the PLUMED driver on an exported input where a plumed binary exists.
11. Multi-GPU (`multi_gpu`, the kernels' counts zeroed before and read
   after), on the mesh of every visible card, or of the one card listed
   four times (five, or the most cards that divide 10, for the 10 HTICA
   subspaces and deep-TICA tries): the Featurizer's auto-shard on the DCD
   with float32 and int16 uploads (K1 on each shard of each chunk), held
   to the one-device features and phase 3's (bit-equal expected) and to
   phase 10's int16 bound; FramesToCV over the 100,000 frames; entropy and
   std of the host feature matrix, feature-sharded; TICA at 100,000 x 586
   with frame-sharded covariances (its projection held to the one-device
   one within the one-ulp spread); the streaming HTICA at phase 4's shape
   with its subspaces over the mesh; deep-TICA with its tries over the
   mesh (2 epochs); the 2-D FES with each block's samples over the mesh
   (K2 on each shard); one Adam and one SGD data-parallel step over an
   NCCL group of one process (SGD's held to the full batch's gradient).
   Each step runs warm once on a mesh of the first card alone and once on
   the mesh, then is timed once each way: on one device, on the mesh
   (`use_mesh`) and by its default route (no mesh set:
   `parallel.mesh.mesh_for`'s per-path default, on one card the one-device
   run); each route's result is held to the one-device one. One line a
   step gives the three times and their ratios to one device.

Prints the nvidia-smi line, the [smoke] lines (times beside the card's name
and power limit), then one JSON line {"kernels": [...]} (each kernel's
launches as its wrapper counts them, summed over the main path and phases 4,
6, 7, 8, 9, 10 and 11, and by path; and, apart, the launches of the CUDA graphs'
replays in phase 10, which no wrapper sees, read from a torch.profiler trace), then,
as the last line, {"ok": true, "device": {...}}. The total time is the last
[smoke] line. The phases run one after another in this process.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 100_000
N_ATOMS = 48
CHUNK = 20_000           # featurize frame chunk asked for (bench.py's CHUNK)
NUM_BINS = 150           # FES grid per axis (the config's default num_bins)
BANDWIDTH = 0.05
SEED = 0
THERMAL_JITTER = 0.2     # Angstrom, per coordinate and frame
STD_QUANTILE = 0.5       # keep features whose std is not below the median
K3_FRAMES, K3_ATOMS = 256, 1000   # a dRMSD-sized selection, ragged vs any tile

# The deep-TICA training of bench.py:342-430 through the calculator.
TRAIN_CONFIG = {
    "dimension": 2,
    "lag_time": 10,
    "features_normalization": "mean_std",
    "tica_regularization": 1e-6,
    "architecture": {"encoder": {
        "layers": [64, 64],
        "activation": ["tanh", "tanh"],
        "last_layer_activation": None,
    }},
    "training": {
        "general": {"num_tries": 10, "lengths": [0.8, 0.2], "batch_size": 4096,
                    "max_epochs": 10, "shuffle": True, "seed": 42,
                    "check_val_every_n_epoch": 1, "save_check_every_n_epoch": 1},
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}},
        "model_to_save": "best",
        # no training figures (matplotlib is not on the card machine)
        "plot_loss": False,
    },
}
CUT_FRAMES, CUT_TRIES, CUT_EPOCHS = 20_000, 2, 2

# Phase 4: the CV file surface and the linear CVs at the main path's width.
LINEAR_CONFIG = {"dimension": 2, "lag_time": 10, "features_normalization": "mean_std",
                 "tica_regularization": 1e-6, "num_subspaces": 10,
                 "subspaces_dimension": 5, "training": {"plot_loss": False}}
COLVARS_FRAMES = 20_000   # the colvars file: a cut of depth from 100,000 (~210 MB)
COLVARS_FMT = "%.6f"
COLVARS_TOL = 1e-6        # half a unit of the 6th decimal + float32 rounding (< 8 nm)
HTICA_STREAM_FEATURES = 580  # 10 equal subspaces of 58
CARD_CPU_FRAMES = 5_000
BREAKDOWN_EPOCHS = 2     # the training run under sync debug mode and the profiler
FES_REPEATS = 5          # the 2-D FES timed again after the main path

# Published peaks of one H100 SXM (NVIDIA data sheet; 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_OPS_PER_CLOCK_PER_SM = 16   # exp2 etc. on the special-function units

K1_TOL = 1e-5                   # nm, absolute
K2_ATOL, K2_RTOL = 1e-4, 1e-5   # log density: fp32 rounding of -|d|^2
ADVERSARIAL_GRID_STRETCH = 2.5  # K2's far grid: [-2.5, 2.5]^2 around [-1, 1]^2 data
FES_TOL = 1e-3                  # kJ/mol against float64 numpy
K3_TOL = 1e-5                   # Angstrom, absolute (+1e-6 relative)
PROJECTION_TOL = 1e-4           # the repo's projection contract
# Card against CPU training: the same batches and initial parameters, float32
# sums in other orders compounded over the steps (the card test holds a toy
# run to the same): losses within rel 1e-4, projections within the contract.
# The AE's default leaky_relu is the exception: its slope jumps from 1 to
# 0.01 at 0, so a pre-activation that rounding puts on the other side of 0
# changes that row's gradient by a finite amount, and the trained net is not
# a continuous function of its inputs. One float32 ulp of input noise moves
# the projection after two Adam steps by 3e-3 to 8e-3 on the CPU (2e-2 on
# 20,000 frames), against 5e-6 with tanh in its place (`ae_float32_floor.py`);
# the optimizer does not cause it (SGD: 7e-5 to 5e-4 against 4e-6). So the
# leaky_relu AE's card-against-CPU gap is held to the card's own one-ulp
# spread, measured over several seeds of input noise in the same run, with
# its losses held (`ae_card_cpu_leaky_relu_*`), and the AE's projection is
# held to the contract on the same cut with tanh (`ae_card_cpu_tanh_*`).
CARD_CPU_LOSS_RTOL = 1e-4
# TICA and HTICA at 586 features: C0 of the normalized features has a
# condition number near 2e7 (`*_c0_condition`), and HTICA's level-1
# subspaces keep 5 eigenvectors where the 5th eigenvalue nearly ties the
# 6th, so float32 rounding anywhere (summation order, eigensolver, input)
# moves the projections far more than the contract's 1e-4, in either
# package, while the eigenvalues stay within 1e-4. Each run measures that
# floor: the spread between in-memory runs on inputs one float32 ulp apart
# (`*_ulp_noise_spread`). Every float32 projection of these CVs (streaming,
# in memory, card, CPU) is held to the contract or to ULP_SPREAD_MULTIPLE
# times the floor, whichever is larger, after the sign fix: against each
# other and, on the streamed frames, against a float64 solve of the same
# estimator (`float64_linear_cv`). PCA is well conditioned: its floor is
# ~1e-6, so the contract holds it.
EIGVAL_TOL = 1e-4
ULP_SPREAD_MULTIPLE = 3
# The leaky_relu AE, card against CPU: seeds of one-ulp input noise whose
# spreads on the card give the distribution that the gap is held to.
AE_NOISE_SEEDS = 6
# The streaming moments sum in float64: their C0 is float32's rounding of
# the float64 one (~6e-8 relative), held here with a margin.
STREAMED_C0_RTOL = 1e-6
ZIP_TOL = 1e-5            # a model.zip projects as the calculator it came from

# Phase 6: the autoencoders, with the schema's default encoder
# (config/schemas.py NEURAL_NETWORK) and no decoder block, so that the
# decoder mirrors it; the main path's training settings.
AUTOENCODER_CONFIG = {
    "dimension": 2,
    "features_normalization": "mean_std",
    "architecture": {"encoder": {"layers": [64, 32, 16],
                                 "activation": ["leaky_relu"] * 3}},
    "training": TRAIN_CONFIG["training"],
}
BN_EPOCHS = 2             # the batchnorm AE: the fold, not the training, is checked
BN_FOLD_TOL = 1e-5        # folded net against the batchnorm net on all training rows
TORCHSCRIPT_TOL = 1e-5    # a PLUMED *_weights.pt against the calculator's projection
COMBINE_TOL = 1e-4        # a linear PLUMED input's COMBINE chain against the projection

# Phase 7: the trajectory inputs and the clustering of traj_cluster, with the
# schema's settings (config/schemas.py TrajClusterSchema).
TRAJ_SPLITS = (33_333, 74_444)   # three XTC trajectories of uneven length
XTC_CHECK_STRIDE = 50            # XTC features held to numpy on every 50th frame
XTC_FEATURES_TOL = 1e-4          # nm / sin, cos against float64 numpy
KMEANS_SETTINGS = {"algorithm": "kmeans", "n_init": 20, "search_interval": [3, 10]}
HIERARCHICAL_SETTINGS = {"algorithm": "hierarchical", "linkage": "complete",
                         "search_interval": [3, 10]}
HDBSCAN_SETTINGS = {"min_cluster_size": 5, "min_samples": 3,
                    "cluster_selection_method": "eom"}
SCORES_CUT = 10_000        # rows held to a float64 numpy computation of the scores
HDBSCAN_CUT = 20_000       # rows of the card-against-CPU HDBSCAN
# HDBSCAN's deep run (core distances, Prim's tree, then the whole fit): a
# cut of depth, every second row of the first 80,000, that keeps the
# script's time with phase 9 in it (Prim's tree is launch bound, ~0.3 ms a
# step, and runs twice).
HDBSCAN_DEPTH = 40_000
HIERARCHICAL_CUT = 5_000   # rows of the hierarchical scan (8 complete-linkage trees)
NN_SAMPLE = 1_000          # nearest-neighbour rows checked against numpy
SCORES_RTOL = 1e-4         # float32 scores against float64
HDBSCAN_TOL = 1e-9         # float64 probabilities and centroids, card against CPU
# A float32 d2 expansion |a|^2 - 2 a.b + |b|^2 rounds each term: a reported
# nearest point may be farther than the float64 nearest by this many float32
# ulps of |a|^2 + |b|^2, and no more.
NN_ULPS = 4

# Phase 8: geometry analysis, augmentation, hydrogen bonds, the Müller-Brown
# sampler and the UMAP CV, on the main path's data.
GEOM_CHECK_STRIDE = 50     # RMSD, RMSF, dRMSD, augmented and H-bond frames checked
GEOM_TOL = 1e-4            # Angstrom, against float64 numpy and the port on the CPU
DRMSD_TOL = 1e-5           # nm (the featurizer's unit): 1e-4 Angstrom
AUGMENTED_FRAMES = 150_000
XTC_GRID_TOL = 0.0051      # Angstrom: half of XTC's 0.01 Angstrom grid, + float32
# 250 atoms x 50,000 frames: 150 MB of coordinates (a cut of depth from
# 100,000, for the script's time; the peptide is generated by a host loop)
HBOND_RESIDUES, HBOND_FRAMES = 50, 50_000
HBOND_SETTINGS = {"first_selection": "all", "second_selection": "all",
                  "d_a_cutoff": 6.0, "d_h_a_angle_cutoff": 90.0, "donors_sel": "name N",
                  "hydrogens_sel": "name H", "acceptors_sel": "name O"}
# An event may differ from the float64 mask only where its distance or angle
# lies within this relative distance of the cutoff (float32 geometry).
HBOND_EDGE_RTOL = 1e-5
MB_CHECK_STEPS = 1_000     # Langevin steps held to float64 numpy with the same noise
MB_TOL = 1e-4
UMAP_KNN_SAMPLE = 1_000    # kNN rows held to float64 numpy
UMAP_KNN_CUT = 50_000      # the kNN again on these first rows (other query tiles)
SIGMA_RTOL = 1e-3          # sum exp(-(d - rho)/sigma) against log2(k)
# One layout epoch, card against CPU: the card's index_add_ sums the updates
# of a row (up to ~900 at 100,000 frames) in no fixed order, an epoch at the
# first learning rate moves points by up to ~270, and a negative sample near
# its head amplifies a last-bit difference ~1,000-fold, so the card parts
# from itself by ~1e-3 between runs on the same inputs. The epoch is held to
# max(LAYOUT_TOL, ULP_SPREAD_MULTIPLE x the card's spread), the spread taken
# over LAYOUT_REPEATS runs and a run from the embedding with one ulp of noise.
LAYOUT_TOL = 1e-5
LAYOUT_REPEATS = 5
UMAP_CUT = 5_000           # rows of the card-against-CPU fit

# Phase 9: the pipeline through its command line (deep_carto_torch), full
# width (48 CA, 1,171 features), depth cut to the time budget.
PIPELINE_TRAIN = (0, 20_000)           # training frames: phase 4's depth
PIPELINE_SEED = (20_000, 40_000, 200)  # 100 seed frames, augmented to 1,000
PIPELINE_SUP = (40_000, 45_000)        # supplementary frames
PIPELINE_CHECK_STRIDE = 50             # colvars rows held to float64 numpy
# %.4f rounding of the colvars text plus the features' 1e-4 against numpy
PIPELINE_FEATURES_TOL = 5e-5 + 1e-4
PIPELINE_CSV_TOL = 5.0001e-5           # a CSV value against its %.4f rounding
PIPELINE_NN_SAMPLE = 1_000             # supplementary rows checked against numpy
PIPELINE_CVS = ["pca", "ae", "tica", "htica", "deep_tica", "vae", "umap"]
PIPELINE_CONFIG = {
    "analyze_geometry": {"analysis": {
        "RMSD": {"ca_rmsd": {"title": "CA RMSD", "selection": "name CA",
                             "fit_selection": "name CA"}},
        "RMSF": {"ca_rmsf": {"title": "CA RMSF", "selection": "name CA",
                             "fit_selection": "name CA"}},
        "dRMSD": {"ca_drmsd": {"title": "CA dRMSD", "selection": "name CA"}},
    }},
    "traj_augmentation": {"num_frames": 1000, "interpolation_method": "pchip",
                          "traj_format": "xtc"},
    "compute_features": {
        "plumed_settings": {"features": {
            "distance_groups": {"ca": {
                "first_selection": "name CA", "second_selection": "name CA",
                "first_stride": 1, "second_stride": 1, "skip_neigh_residues": True,
                "skip_bonded_atoms": False}},
            "dihedral_groups": {"tors": {"selection": "name CA",
                                         "periodic_encoding": True,
                                         "search_mode": "virtual"}},
        }},
        "engine": {"frame_chunk": CHUNK},
    },
    "filter_features": {"filter_settings": {
        "compute_diptest": False, "compute_entropy": False,
        "std_quantile": STD_QUANTILE}},
    "train_colvars": {
        "cvs": PIPELINE_CVS,
        "common": {
            "dimension": 2,
            "lag_time": 10,
            "features_normalization": "mean_std",
            "training": TRAIN_CONFIG["training"],
        },
        "deep_tica": {"architecture": {"encoder": {
            "layers": [64, 64], "activation": ["tanh", "tanh"],
            "batchnorm": [False, False], "dropout": [None, None]}}},
        "figures": {"fes": {"compute": False}, "traj_projection": {"plot": False}},
    },
    "traj_projection": {"figures": {"fes": {"compute": False},
                                    "traj_projection": {"plot": False}}},
    "traj_cluster": dict(KMEANS_SETTINGS, output_structures="centroids",
                         figures={"plot": False}),
}

# Phase 10: the native host I/O and transport, on the main path's data.
COLVARS_PLAIN_ROWS = 2_000    # rows of the native file the Python writer must give
DIP_PLAIN_FEATURES = 16       # kept features held to the Python dip
DIP_TOL = 1e-12               # p-values, batch against the Python dip
HTICA_BLOCK = 2_000           # generated block: 10 blocks of phase 4's 20,000 frames
HTICA_BLOCKS_PER_DISPATCH = 5
FUSED_TOL = 1e-5              # fit_fused and fit_chunked against fit (same moments)
# Phase 11: a data-parallel SGD step's summed gradient against the full
# batch's (float32 sums over 8,192 rows in another order).
DP_GRADIENT_RTOL = 1e-4
# int16 features against float32 (int16_excess, dihedral_error_bound): the
# float32 rounding of the two feature computations, beyond what the
# quantization moves.
INT16_FLOAT32_ALLOWANCE = 4e-6
# Each wrapper's kernel as a torch.profiler trace names it on the card (K2's
# first kernel: the partial sums; one per launch).
TRACE_NAMES = {"pair_distances_kernel": "pair_distances_kernel",
               "kde_logsumexp_kernel": "kde_partial_kernel",
               "pairwise_distance_matrix_kernel": "pairwise_distance_matrix_kernel"}
DEMO_DATASET, DEMO_SYSTEM = "calpha_transitions", "1rcs_B-3ssx_R-3"


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Workload (bench.py:97-125, copied: bench.py imports JAX; plus jitter)
# ---------------------------------------------------------------------------

def make_trajectory(n_frames: int, n_atoms: int,
                    jitter: float = THERMAL_JITTER) -> np.ndarray:
    """bench.py's helix with 8 slow sine modes, plus thermal jitter."""
    rng = np.random.default_rng(SEED)
    t = np.linspace(0, 4 * np.pi, n_atoms)
    base = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * t], 1).astype(
        np.float32
    )
    n_modes = 8
    phases = rng.uniform(0, 2 * np.pi, n_modes).astype(np.float32)
    freqs = rng.uniform(0.5, 3.0, n_modes).astype(np.float32)
    shapes = (rng.standard_normal((n_modes, n_atoms, 3)) * 0.3).astype(np.float32)
    tt = np.arange(n_frames, dtype=np.float32) / n_frames * 2 * np.pi
    waves = np.sin(freqs[None, :] * tt[:, None] + phases[None, :])
    coords = base[None] + np.einsum("fm,mad->fad", waves, shapes)
    # Thermal jitter (not in bench.py): without it the lag-10 motion is
    # deterministic, the batch TICA eigenvalues sit at 1, and the estimator
    # (C0 from x_t only) lets training push them past 1, which the
    # calculator's -dimension bound then rejects. The JAX calculator does
    # the same on that data (tests/test_torch_deep_tica.py).
    coords += rng.normal(0.0, jitter, coords.shape)
    return coords.astype(np.float32)


def make_labels(n_atoms: int):
    """All non-neighbor CA pair distances + sin/cos of consecutive virtual
    dihedrals — the feature families of the reference's default config."""
    labels = []
    for i in range(1, n_atoms + 1):
        for j in range(i + 2, n_atoms + 1):
            labels.append(f"dist-@CA_{i}-@CA_{j}")
    n_dihedrals = n_atoms - 3
    for i in range(1, n_dihedrals + 1):
        labels.append(f"sin-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}")
        labels.append(f"cos-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}")
    return labels


def write_ca_pdb(path: str, coords_frame: np.ndarray) -> None:
    residues = ["ALA", "GLY", "SER", "VAL", "LEU", "THR", "PRO", "PHE"]
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords_frame):
            fh.write(
                f"ATOM  {i + 1:>5}  CA  {residues[i % 8]:<4}A{i + 1:>4}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}           C\n"
            )
        fh.write("END\n")


def cv_like_samples(n: int, seed: int) -> np.ndarray:
    """Two-basin 2-D samples in [-1, 1]^2, the range of post-normalized CVs."""
    rng = np.random.default_rng(seed)
    centers = np.array([[-0.5, 0.3], [0.4, -0.2]])
    x = centers[rng.integers(0, 2, n)] + rng.normal(0, 0.2, (n, 2))
    return np.clip(x, -1, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """First line of nvidia-smi's answer to --query-gpu=`query`."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(n_bytes: float, flops: float, sfu_ops: float, sfu_rate: float):
    """Least time for the work on this card, and what sets it."""
    times = {
        "bytes": n_bytes / HBM_BYTES_PER_S,
        "operations": max(flops / FP32_FLOPS, sfu_ops / sfu_rate),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def check_k2_adversarial(grid, samples, inv_two_bw2: float) -> dict:
    """K2 against its plain version at the main path's shape on inputs that
    need its running max: the grid pushed out so that every corner is
    farther than sqrt(200) scaled units from every sample (exp underflows in
    float32 there), and the samples sorted by distance from a corner,
    farthest first, so that the max rises tile after tile."""
    import torch

    from deep_cartograph_torch.ops import kde as k2

    far_grid = grid * ADVERSARIAL_GRID_STRETCH
    corners = far_grid[[0, NUM_BINS - 1, -NUM_BINS, -1]]
    corner_d2 = float(torch.cdist(corners, samples).min() ** 2 * inv_two_bw2)
    check(corner_d2 > 200.0, f"every grid corner is far from the samples ({corner_d2})")
    order = torch.argsort(((samples - far_grid[0]) ** 2).sum(1), descending=True)
    sorted_samples = samples[order].contiguous()
    got = k2.kde_logsumexp(far_grid, sorted_samples, inv_two_bw2)
    torch.cuda.synchronize()
    scale = torch.sqrt(torch.tensor(inv_two_bw2, dtype=torch.float32)).to(grid.device)
    want = k2.kde_logsumexp_plain(far_grid * scale, sorted_samples * scale)
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= K2_ATOL + K2_RTOL * want.abs()).all()),
          f"K2 agrees with its plain version on far, sorted inputs (max err {err})")
    return {"adversarial_max_abs_err": err,
            "adversarial_min_value": float(want.min()),
            "adversarial_corner_scaled_d2": corner_d2}


def check_kernels(coords: np.ndarray, pairs_np: np.ndarray, sfu_rate: float):
    """Phase 2: each kernel against its plain version at the main path's
    shapes, with timings. Returns the per-kernel records."""
    import torch

    from deep_cartograph_torch.geom.engine import auto_chunk_size
    from deep_cartograph_torch.ops import kde as k2
    from deep_cartograph_torch.ops import pair_distances as k1
    from deep_cartograph_torch.ops import pairwise_distance_matrix as k3

    dev = torch.device("cuda")
    records = {}

    # K1 on one featurize chunk.
    chunk = auto_chunk_size(CHUNK, N_ATOMS, len(make_labels(N_ATOMS)))
    points = torch.tensor(coords[:chunk], device=dev)
    pairs = torch.tensor(pairs_np, device=dev)
    got = k1.pair_distances(points, pairs)
    torch.cuda.synchronize()
    want = k1.pair_distances_plain(points, pairs)
    err = float((got - want).abs().max())
    check(err <= K1_TOL, f"K1 agrees with its plain version (max err {err})")
    out = torch.empty_like(got)
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    C, N, P = points.shape[0], points.shape[1], pairs.shape[0]
    k1_bound, k1_by = bound_ms(
        n_bytes=C * N * 12 + P * 8 + C * P * 4, flops=10.0 * C * P,
        sfu_ops=0.0, sfu_rate=sfu_rate,
    )
    records["K1"] = {
        "name": "pair_distances_kernel",
        "route": "cuda",
        "source": "deep_cartograph_torch/ops/csrc/pair_distances.cu",
        "replaces": "deep_cartograph_tpu/ops/pallas_kernels.py:220",
        "tpu_function": "selector_pair_distances",
        "shape": {"C": C, "N": N, "P": P},
        "max_abs_err": err,
        "tolerance": f"abs {K1_TOL} nm",
        "ms": cuda_ms(lambda: k1.launch(points, pairs, out), 50),
        "plain_ms": cuda_ms(lambda: k1.pair_distances_plain(points, pairs), 10),
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": cuda_ms(
            lambda: torch.cdist(points, points)[:, a, b] * 0.1, 10
        ),
        "library_call": "torch.cdist over the chunk's atoms, pairs gathered",
    }

    # K2 on the 2-D FES shape: 150 x 150 grid, 100,000 samples.
    samples = torch.tensor(cv_like_samples(N_FRAMES, SEED + 1), device=dev)
    axis = torch.linspace(-1, 1, NUM_BINS, device=dev)
    gx, gy = torch.meshgrid(axis, axis, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1).contiguous()
    inv_two_bw2 = 1.0 / (2.0 * BANDWIDTH * BANDWIDTH)
    got = k2.kde_logsumexp(grid, samples, inv_two_bw2)
    torch.cuda.synchronize()
    scale = float(torch.sqrt(torch.tensor(inv_two_bw2, dtype=torch.float32)))
    grid_s, samples_s = grid * scale, samples * scale
    want = k2.kde_logsumexp_plain(grid_s, samples_s)
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= K2_ATOL + K2_RTOL * want.abs()).all()),
          f"K2 agrees with its plain version (max err {err})")
    out = torch.empty_like(got)
    G, D, Ns = grid.shape[0], grid.shape[1], samples.shape[0]

    def library_k2():
        return torch.cat([
            torch.logsumexp(-torch.cdist(g, samples_s) ** 2, dim=1)
            for g in torch.split(grid_s, 2048)
        ])

    k2_bound, k2_by = bound_ms(
        n_bytes=(G * D + Ns * D + G) * 4, flops=(3.0 * D + 1) * G * Ns,
        sfu_ops=float(G) * Ns, sfu_rate=sfu_rate,
    )
    records["K2"] = {
        "name": "kde_logsumexp_kernel",
        "route": "cuda",
        "source": "deep_cartograph_torch/ops/csrc/kde_logsumexp.cu",
        "replaces": "deep_cartograph_tpu/ops/pallas_kernels.py:137",
        "tpu_function": "kde_logsumexp",
        "shape": {"G": G, "D": D, "N": Ns},
        "max_abs_err": err,
        "tolerance": f"abs {K2_ATOL} + {K2_RTOL} x |plain|",
        "ms": cuda_ms(lambda: k2.launch(grid_s, samples_s, out), 10),
        "plain_ms": cuda_ms(lambda: k2.kde_logsumexp_plain(grid_s, samples_s), 3),
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": cuda_ms(library_k2, 3),
        "library_call": "torch.logsumexp over -torch.cdist(grid, samples)**2, "
                        "2048 grid rows at a time",
    }
    records["K2"].update(check_k2_adversarial(grid, samples, inv_two_bw2))

    # K3 on a dRMSD-sized selection: 256 frames x 1,000 atoms.
    coords3 = torch.tensor(make_trajectory(K3_FRAMES, K3_ATOMS), device=dev)
    got = k3.pairwise_distance_matrix(coords3)
    torch.cuda.synchronize()
    want = k3.pairwise_distance_matrix_plain(coords3)
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= K3_TOL + 1e-6 * want.abs()).all()),
          f"K3 agrees with its plain version (max err {err})")
    del want, diff
    out = torch.empty_like(got)
    F3, A3 = coords3.shape[0], coords3.shape[1]
    k3_bound, k3_by = bound_ms(
        n_bytes=F3 * A3 * 12 + F3 * A3 * A3 * 4, flops=9.0 * F3 * A3 * A3,
        sfu_ops=0.0, sfu_rate=sfu_rate,
    )
    records["K3"] = {
        "name": "pairwise_distance_matrix_kernel",
        "route": "cuda",
        "source": "deep_cartograph_torch/ops/csrc/pairwise_distance_matrix.cu",
        "replaces": "deep_cartograph_tpu/ops/pallas_kernels.py:61",
        "tpu_function": "pairwise_distance_matrix",
        "main_path": "no main-path caller (none in the JAX package either)",
        "shape": {"F": F3, "A": A3},
        "max_abs_err": err,
        "tolerance": f"abs {K3_TOL} A + 1e-6 x |plain|",
        "ms": cuda_ms(lambda: k3.launch(coords3, out), 20),
        "plain_ms": cuda_ms(lambda: k3.pairwise_distance_matrix_plain(coords3), 3),
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": cuda_ms(lambda: torch.cdist(
            coords3, coords3, compute_mode="donot_use_mm_for_euclid_dist"), 5),
        "library_call": "torch.cdist(coords, coords, "
                        "compute_mode='donot_use_mm_for_euclid_dist')",
        "library_mm_ms": cuda_ms(lambda: torch.cdist(
            coords3, coords3, compute_mode="use_mm_for_euclid_dist"), 5),
    }
    del coords3, got, out
    torch.cuda.empty_cache()
    return records


def numpy_features(coords: np.ndarray, labels) -> np.ndarray:
    """Independent float64 reference for the make_labels features."""
    c = coords.astype(np.float64)
    cols = []
    for label in labels:
        kind, *ents = label.split("-")
        idx = [int(e.rsplit("_", 1)[1]) - 1 for e in ents]
        if kind == "dist":
            cols.append(np.linalg.norm(c[:, idx[0]] - c[:, idx[1]], axis=-1) * 0.1)
            continue
        p0, p1, p2, p3 = (c[:, i] for i in idx)
        b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
        b1n = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
        v = b0 - np.sum(b0 * b1n, -1, keepdims=True) * b1n
        w = b2 - np.sum(b2 * b1n, -1, keepdims=True) * b1n
        ang = np.arctan2(np.sum(np.cross(b1n, v) * w, -1), np.sum(v * w, -1))
        cols.append(np.sin(ang) if kind == "sin" else np.cos(ang))
    return np.stack(cols, 1)


def numpy_fes_1d(x: np.ndarray, axis: np.ndarray, kt: float) -> np.ndarray:
    logk = -((axis[:, None].astype(np.float64) - x[None, :]) ** 2) / (
        2.0 * BANDWIDTH**2
    )
    m = logk.max(1, keepdims=True)
    fes = -kt * (m[:, 0] + np.log(np.exp(logk - m).sum(1)))
    return fes - fes.min()


def synced(fn, device="cuda"):
    """(fn(), host seconds) with the device drained before and after."""
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_training(calc, dimension: int, result: dict) -> None:
    """The training checks: finite losses, the selected try improved,
    scores above -dimension, TICA eigenvalues in (0, 1]."""
    for try_num, r in calc.try_results:
        for key in ("train_loss", "valid_loss"):
            check(bool(np.isfinite(r.metrics[key]).all()),
                  f"try {try_num} {key} finite")
    vl = calc.metrics["valid_loss"]
    check(vl[-1] < vl[0], f"selected try's validation loss fell ({vl[0]} -> {vl[-1]})")
    valid = [r.score for _, r in calc.try_results if calc._validate_result(r)]
    check(len(valid) > 0 and min(valid) >= -dimension,
          f"selected scores >= -{dimension}: {valid}")
    ev = np.asarray(calc.eigenvalues_)
    check(bool(((ev > 0) & (ev <= 1)).all()), f"TICA eigenvalues in (0, 1]: {ev}")
    result["tries"] = [
        {"try": n, "score": r.score, "best_epoch": r.best_epoch,
         "description": r.description} for n, r in calc.try_results
    ]
    result["selected_score"] = calc.cv_score
    result["tica_eigenvalues"] = ev.tolist()
    result["selected_valid_loss"] = vl


def main_path(coords: np.ndarray, tmp: str, stats) -> dict:
    """Phase 3: featurize, filter, train, serve and draw, through the port's
    entry points."""
    import torch

    from deep_cartograph_torch.cv.deep import DeepTICACalculator
    from deep_cartograph_torch.deploy import FramesToCV
    from deep_cartograph_torch.fes.kde import KB_KJ_MOL, compute_fes
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.dcd import read_dcd, write_dcd
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.io.traj import iter_frame_chunks
    from deep_cartograph_torch.stats.descriptors import (
        quantile_mask,
        shannon_entropy,
        standard_deviation,
    )

    pdb_path = os.path.join(tmp, "ca.pdb")
    dcd_path = os.path.join(tmp, "traj.dcd")
    write_ca_pdb(pdb_path, coords[0])
    write_dcd(dcd_path, coords)
    labels = make_labels(N_ATOMS)
    top = Topology.from_pdb(pdb_path)
    featurizer = Featurizer(top, labels)
    result = {}

    # Host decode alone, for the breakdown of the featurize time: the
    # prefetching native reader (what iter_frame_chunks takes), then the
    # read_dcd slices it replaced.
    t0 = time.perf_counter()
    for _ in iter_frame_chunks(dcd_path, CHUNK):
        pass
    result["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for start in range(0, N_FRAMES, CHUNK):
        read_dcd(dcd_path, start, start + CHUNK)
    result["decode_slices_s"] = time.perf_counter() - t0

    for s in stats:
        s.launches = 0
    features, result["featurize_s"] = synced(
        lambda: featurizer.featurize_trajectory(dcd_path, frame_chunk=CHUNK))

    # The feature matrix goes up once; statistics, filter and training read
    # it on the card.
    feats_d, result["upload_s"] = synced(lambda: torch.as_tensor(features).cuda())
    (entropy, std), result["stats_s"] = synced(
        lambda: (shannon_entropy(feats_d), standard_deviation(feats_d)))

    def screen():
        keep = quantile_mask(std, STD_QUANTILE)
        cols = torch.as_tensor(np.nonzero(keep)[0], device="cuda")
        return keep, feats_d.index_select(1, cols)

    (keep, kept_features), result["filter_s"] = synced(screen)
    _, result["filter_again_s"] = synced(screen)  # kernels loaded: the warm cost
    kept = [lab for lab, k in zip(labels, keep) if k]
    result["n_kept"] = len(kept)

    calc = DeepTICACalculator(TRAIN_CONFIG)
    _, result["set_data_s"] = synced(lambda: calc._set_training_data(
        kept_features, np.zeros(N_FRAMES, np.int64), kept))
    trained, result["train_s"] = synced(calc.train)
    check(trained, "training produced a valid model")
    _, result["normalize_cv_s"] = synced(calc.normalize_cv)

    pipeline = FramesToCV(calc.projection(), top, kept)
    frames = read_dcd(dcd_path)
    cv, result["project_s"] = synced(lambda: pipeline(frames))
    cv_from_features = calc.project_data(kept_features)

    kt = KB_KJ_MOL * 300.0
    fes_1d = []
    t0 = time.perf_counter()
    for k in range(2):
        fes_1d.append(compute_fes(cv[:, k], bandwidth=BANDWIDTH,
                                  num_bins=NUM_BINS, num_blocks=100))
    result["fes_1d_s"] = time.perf_counter() - t0
    (axes_2d, fes_2d, err_2d), result["fes_2d_s"] = synced(lambda: compute_fes(
        cv, bandwidth=BANDWIDTH, num_bins=NUM_BINS, num_blocks=1))
    result["launches"] = {s.name: s.launches for s in stats}
    # The 2-D FES again (kernels warm), after the launch counts are read.
    result["fes_2d_again_s"] = [
        synced(lambda: compute_fes(cv, bandwidth=BANDWIDTH, num_bins=NUM_BINS,
                                   num_blocks=1))[1]
        for _ in range(FES_REPEATS)
    ]

    # Checks.
    check(features.shape == (N_FRAMES, len(labels)) == (N_FRAMES, 1171),
          f"feature matrix shape {features.shape}")
    check(bool(np.isfinite(features).all()), "features are finite")
    ref = numpy_features(coords[:256], labels)
    result["features_err_vs_numpy"] = float(np.abs(features[:256] - ref).max())
    check(result["features_err_vs_numpy"] <= 1e-4, "features match numpy")
    check(entropy.shape == std.shape == (1171,) and bool(np.isfinite(entropy).all()),
          "filter statistics finite")
    ref_std = np.round(features.astype(np.float64).std(0), 3)
    result["std_err_vs_numpy"] = float(np.abs(std - ref_std).max())
    check(result["std_err_vs_numpy"] <= 1.0001e-3, "rounded std matches numpy")
    check_training(calc, TRAIN_CONFIG["dimension"], result)
    check(cv.shape == (N_FRAMES, 2) and bool(np.isfinite(cv).all()),
          f"CV values finite, shape {cv.shape}")
    result["cv_err_vs_project_data"] = float(np.abs(cv - cv_from_features).max())
    check(result["cv_err_vs_project_data"] <= PROJECTION_TOL,
          "FramesToCV matches the calculator's project_data on the kept features")
    for k, (axes, fes, err) in enumerate(fes_1d):
        check(fes.shape == err.shape == (NUM_BINS,), f"1-D FES {k} shape")
        check(bool(np.isfinite(fes).all()) and fes.min() == 0.0,
              f"1-D FES {k} finite with min 0")
        ref = numpy_fes_1d(cv[:, k].astype(np.float64), axes[0], kt)
        result[f"fes_1d_{k}_err_vs_numpy"] = float(np.abs(fes - ref).max())
        check(result[f"fes_1d_{k}_err_vs_numpy"] <= FES_TOL,
              f"1-D FES {k} matches numpy within {FES_TOL} kJ/mol")
    check(fes_2d.shape == (NUM_BINS, NUM_BINS) and err_2d is None, "2-D FES shape")
    check(bool(np.isfinite(fes_2d).all()) and fes_2d.min() == 0.0,
          "2-D FES finite with min 0")
    for s in stats:
        if s.name == "pairwise_distance_matrix_kernel":
            check(s.launches == 0, "K3 has no caller on the main path")
        else:
            check(s.launches > 0, f"{s.name} was launched on the main path")
    context = {"features": features, "kept_features": kept_features, "kept": kept,
               "cv": cv, "entropy": entropy, "std": std, "fes_2d": fes_2d,
               "pdb_path": pdb_path, "dcd_path": dcd_path, "frames": frames}
    return result, calc, context


def count_syncs(fn):
    """Host syncs that `fn` makes with the card (torch's sync debug mode),
    counted by the line of code that makes them."""
    import collections
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)
    )


# Runtime calls in which the host waits for the card.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def calculator(cv: str, config: dict, data, labels, device="cuda", **general):
    """A `cv` calculator of `config` (its training's general block updated by
    `general`) with `data` (one trajectory) as its training data."""
    import copy

    from deep_cartograph_torch.cv import cv_calculators_map

    config = copy.deepcopy(config)
    config["training"]["general"].update(general)
    calc = cv_calculators_map[cv](config, device=device)
    calc._set_training_data(data, None, labels)
    return calc


def union_us(ranges) -> float:
    """Length of the union of profiler time ranges, in µs: kernels that a
    CUDA graph runs side by side count once."""
    total, reach = 0.0, -np.inf
    for r in sorted(ranges, key=lambda r: r.start):
        start = max(r.start, reach)
        if r.end > start:
            total += r.end - start
            reach = r.end
    return total


def training_breakdown(cv: str, config: dict, calc_main) -> dict:
    """A training on the main path's data (same config and seeds) cut to
    BREAKDOWN_EPOCHS epochs, run twice through the calculator's `train`:
    once under torch's sync debug mode (host syncs by line of code), once
    under torch.profiler (the trainer's step spans: their host time, the
    card time of the kernels they launch, and the sync calls inside them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_cartograph_torch.models.training import STEP_SPAN, TRAIN_STATS

    def make():
        return calculator(cv, config, calc_main.training_data,
                          calc_main.features_ref_labels, max_epochs=BREAKDOWN_EPOCHS)

    calc = make()
    sites = count_syncs(calc.train)
    n_total = len(next(iter(calc.train_datasets().values())))
    steps = int(np.ceil(int(n_total * calc.training_validation_lengths[0])
                        / calc.batch_size))
    out = {"epochs": BREAKDOWN_EPOCHS, "steps_per_epoch": steps,
           "host_syncs_train": sum(sites.values()), "host_sync_sites": dict(sites)}

    calc = make()
    replayed, captures = TRAIN_STATS.replayed_steps, TRAIN_STATS.captures
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = synced(calc.train)
    replayed = TRAIN_STATS.replayed_steps - replayed
    captures = TRAIN_STATS.captures - captures
    events = prof.events()
    host, card = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # A step span lies on the host's timeline and, mirrored, on the card's,
    # from the step's first kernel to its last; a step that captures the
    # trainer's CUDA graph is mirrored twice, once for the capture's own
    # work on its side stream and once for the first replay. The backward's
    # kernels are launched from autograd's own thread, so they are counted
    # by where they run on the card, not by the host span they were
    # launched in. Card time is the union of the kernels' intervals, since
    # a replayed graph runs independent kernels side by side.
    spans = [e.time_range for e in events if e.name == STEP_SPAN and e.device_type == host]
    windows = [e.time_range for e in events if e.name == STEP_SPAN and e.device_type == card]
    work = [e.time_range for e in events if e.device_type == card and e.name != STEP_SPAN]
    syncs = [e.time_range for e in events if e.name in SYNC_CALLS]
    in_steps = sum(any(s.start <= e.start <= s.end for s in spans) for e in syncs)
    device_us = union_us(work)
    step_host_us = sum(s.elapsed_us() for s in spans)
    step_device_us = union_us([w for w in work
                               if any(s.start <= w.start < s.end for s in windows)])
    check(len(windows) == len(spans) + captures, "the profile mirrors every step on the card")
    out.update({
        "profiled_steps": len(spans),
        "profiled_replayed_steps": replayed,
        "profiled_captures": captures,
        "profiled_sync_calls_train": len(syncs),
        "profiled_sync_calls_per_step": in_steps / max(len(spans), 1),
        "profiled_step_ms": step_host_us / max(len(spans), 1) / 1e3,
        "profiled_step_device_ms": step_device_us / max(len(spans), 1) / 1e3,
        "profiled_step_busy_share": step_device_us / max(union_us(windows), 1e-9),
        "profiled_train_s": wall,
        "profiled_train_busy_share": device_us / 1e6 / wall,
    })
    check(len(spans) == BREAKDOWN_EPOCHS * steps,
          f"the profile shows every training step ({len(spans)})")
    return out


def card_against_cpu(cv: str, config: dict, calc_main, frames: int,
                     hold_projection: bool = True) -> dict:
    """The same cut-down training (the main path's first `frames` frames,
    CUT_TRIES tries, CUT_EPOCHS epochs) on the card and on the CPU: the
    per-epoch losses within rel CARD_CPU_LOSS_RTOL, the projections within
    PROJECTION_TOL. Without `hold_projection` (the leaky_relu AE) the
    projections' gap is held to the card's own one-ulp spread instead: the
    same training on the card from AE_NOISE_SEEDS inputs one float32 ulp
    away (seeded noise), each against the card's run without noise
    (`ulp_noise_spread_card`); the gap within ULP_SPREAD_MULTIPLE times
    the largest (`conditioning_tol`). The CPU's spread for one seed is
    recorded beside it (`ulp_noise_spread_cpu`)."""
    x = calc_main.training_data[:frames]
    runs = {}
    cases = [("cuda", "cuda", x), ("cpu", "cpu", x)]
    if not hold_projection:
        cases.append(("noisy", "cpu", with_ulp_noise(x)))
        cases += [(f"noisy_card_{seed}", "cuda", with_ulp_noise(x, seed))
                  for seed in range(AE_NOISE_SEEDS)]
    for name, device, data in cases:
        calc = calculator(cv, config, data, calc_main.features_ref_labels, device,
                          num_tries=CUT_TRIES, max_epochs=CUT_EPOCHS)
        (trained, _), seconds = synced(lambda: (calc.train(), calc.normalize_cv()))
        check(trained, f"cut-down training on {name}")
        runs[name] = (calc, seconds)
    card, host = runs["cuda"][0], runs["cpu"][0]
    result = {"card_s": runs["cuda"][1], "cpu_s": runs["cpu"][1]}
    rel = 0.0
    for (_, a), (_, b) in zip(card.try_results, host.try_results):
        for key in ("train_loss", "valid_loss"):
            ga, gb = np.asarray(a.metrics[key]), np.asarray(b.metrics[key])
            rel = max(rel, float(np.max(np.abs(ga - gb) / np.abs(gb))))
    result["loss_max_rel_diff"] = rel
    check(rel <= CARD_CPU_LOSS_RTOL,
          f"{cv} per-epoch losses on the card match the CPU (max rel diff {rel})")
    on_cpu = host.project_data(x)
    proj = float(np.abs(card.project_data(x) - on_cpu).max())
    result["projection_max_abs_diff"] = proj
    if not hold_projection:
        result["ulp_noise_spread_cpu"] = float(np.abs(runs["noisy"][0].project_data(x)
                                                      - on_cpu).max())
        on_card = card.project_data(x)
        spreads = [float(np.abs(runs[f"noisy_card_{seed}"][0].project_data(x) - on_card).max())
                   for seed in range(AE_NOISE_SEEDS)]
        result["ulp_noise_spread_card"] = spreads
        result["gap_rank_among_card_spreads"] = int(sum(sp < proj for sp in spreads))
        tol = conditioning_tol(max(spreads))
        check(proj <= tol,
              f"{cv} projection on the card within {tol:.3g} of the CPU ({proj}; the card's "
              f"one-ulp spreads over {AE_NOISE_SEEDS} seeds {[f'{sp:.3g}' for sp in spreads]})")
    else:
        check(proj <= PROJECTION_TOL,
              f"{cv} projection on the card matches the CPU (max diff {proj})")
    return result


def align_signs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a's columns flipped to correlate positively with b's."""
    return a * np.sign(np.sum(a * b, axis=0))


def with_ulp_noise(x, seed: int = SEED):
    """x with one float32 ulp of seeded relative noise: the spread a CV
    shows between the two is its float32 conditioning floor."""
    import torch

    x = torch.as_tensor(x)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed))
    return x * (1 + 6e-8 * noise.to(x.device))


def conditioning_tol(spread: float) -> float:
    """A float32 projection's tolerance from its measured one-ulp spread."""
    return max(PROJECTION_TOL, ULP_SPREAD_MULTIPLE * spread)


def float64_linear_cv(x: np.ndarray, subspaces: int, device="cuda"):
    """TICA (subspaces=1) or HTICA of the (frames, features) matrix in
    float64, apart from the port's code: mean_std normalization, lag pairs,
    C0 and the symmetrized Ctau around x_t's mean, the generalized eigh by
    LAPACK (scipy) on C0 + reg I; HTICA keeps subspaces_dimension
    eigenvectors of each equal block and solves level 2 on their
    projections. Returns (eigenvalues, min-max normalized projection)."""
    import scipy.linalg as sla
    import torch

    lag, reg = LINEAR_CONFIG["lag_time"], LINEAR_CONFIG["tica_regularization"]
    dim = LINEAR_CONFIG["dimension"]
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    x = (x - x.mean(0)) / x.std(0)

    def solve(x_t, x_lag, k):
        mu = x_t.mean(0)
        a, b = x_t - mu, x_lag - mu
        c0 = (a.T @ a / len(a)).cpu().numpy()
        ctau = (0.5 * (a.T @ b + b.T @ a) / len(a)).cpu().numpy()
        w, v = sla.eigh(ctau, c0 + reg * np.eye(len(c0)))
        return w[::-1][:k], torch.as_tensor(v[:, ::-1][:, :k].copy(), device=device)

    x_t, x_lag = x[:-lag], x[lag:]
    if subspaces == 1:
        ev, weights = solve(x_t, x_lag, dim)
    else:
        width = x.shape[1] // subspaces
        blocks = [solve(x_t[:, s * width:(s + 1) * width], x_lag[:, s * width:(s + 1) * width],
                        LINEAR_CONFIG["subspaces_dimension"])[1] for s in range(subspaces)]
        level1 = torch.block_diag(*blocks)
        ev, level2 = solve(x_t @ level1, x_lag @ level1, dim)
        weights = level1 @ level2
    proj = (x @ weights).cpu().numpy()
    lo, hi = proj.min(0), proj.max(0)
    return ev, ((proj - (hi + lo) / 2) / ((hi - lo) / 2)).astype(np.float32)


def streamed_c0_errors(stream, x: np.ndarray, subspaces: int) -> dict:
    """Level 1's C0 from StreamingHTICA's moments (the file's frames as one
    block, float64 sums) and from one float32 batched product of the same
    centered pairs, each against float64: the largest relative Frobenius
    error over the subspaces."""
    import torch

    from deep_cartograph_torch.cv.htica_stream import StreamingHTICA, _moments_to_covs

    lag = LINEAR_CONFIG["lag_time"]
    xn = stream._normalize(torch.as_tensor(x, device=stream.device))
    width = xn.shape[1] // subspaces

    def batched(x_t):  # (frames, S * D) -> (S, frames, D), centered
        x_t = x_t - x_t.mean(0)
        return x_t.reshape(x_t.shape[0], subspaces, width).transpose(0, 1)

    a64 = batched(xn[:-lag].double())
    want = a64.transpose(1, 2) @ a64 / a64.shape[1]
    sh = StreamingHTICA(xn.shape[1], subspaces, 1, 1, lag, device=stream.device)
    got = _moments_to_covs(sh._pass(lambda: iter([xn]))[0])[0]
    a32 = batched(xn[:-lag])
    float32 = a32.transpose(1, 2) @ a32 / a32.shape[1]

    def rel(c):
        return float(((c.double() - want).flatten(1).norm(dim=1)
                      / want.flatten(1).norm(dim=1)).max())

    return {"streamed": rel(got), "float32_product": rel(float32)}


def c0_condition(calc) -> float:
    """Condition number of the in-memory TICA calculator's C0, in float64."""
    import torch

    from deep_cartograph_torch.cv.tica_math import timelagged_covariances

    c0 = timelagged_covariances(calc.x_t.double(), calc.x_lag.double())[0]
    ev = torch.linalg.eigvalsh(c0)
    return float(ev.max() / ev.min())


def linear_calculator(cv: str, out: str, device, **config):
    from deep_cartograph_torch.cv import cv_calculators_map

    return cv_calculators_map[cv](dict(LINEAR_CONFIG, **config), out, device=device)


def cv_surface(calc_deep, ctx: dict, tmp: str, stats, card: str, device="cuda") -> dict:
    """Phase 4: the CV calculators' file surface and the linear CVs at the
    main path's width (the kernels' counts zeroed before and read after):

    1. PCA, TICA and HTICA (10 subspaces x 5) trained on the main path's
       device matrix through _set_training_data + run();
    2. a PLUMED colvars file of the main path's features (time + every
       feature, COLVARS_FRAMES frames) written and read back;
    3. the Filter on that file (std at the median) against the main path's
       screen on the same values;
    4. streaming TICA (one subspace, D > 256: the on-card Krylov solver) and
       HTICA from the file against the in-memory calculators on the same
       frames;
    5. the deep-TICA and linear CVs saved as model.zip, loaded back with
       CVCalculator.load, project_colvars of the file against the
       calculators' own projection;
    6. FramesToCV.from_model_zip of the deep-TICA and TICA zips serving every
       frame of the DCD (K1), against project_data of the features;
    7. the linear CVs on the card against the CPU on CARD_CPU_FRAMES frames.
    """
    import torch

    from deep_cartograph_torch.cv.base import CVCalculator
    from deep_cartograph_torch.deploy import FramesToCV
    from deep_cartograph_torch.features.filter import Filter
    from deep_cartograph_torch.io.colvars import read_features_matrix, write_colvars
    from deep_cartograph_torch.stats.descriptors import quantile_mask, standard_deviation

    # Reads parse the file: no same-run memory cache.
    os.environ["DEEP_CARTO_COLVARS_CACHE_BYTES"] = "0"
    features, kept_features, kept = ctx["features"], ctx["kept_features"], ctx["kept"]
    labels = make_labels(N_ATOMS)
    n_frames = kept_features.shape[0]
    out: dict = {}
    for st in stats:
        st.launches = 0

    # 1. Linear CVs at full depth on the device matrix.
    linear = {}
    for cv in ("pca", "tica", "htica"):
        calc = linear_calculator(cv, os.path.join(tmp, "linear"), device)
        calc.ref_topology_path = ctx["pdb_path"]
        _, out[f"{cv}_set_data_s"] = synced(lambda: calc._set_training_data(
            kept_features, np.zeros(n_frames, np.int64), kept))
        _, out[f"{cv}_compute_cv_s"] = synced(calc.compute_cv)
        (proj, cv_labels), out[f"{cv}_run_s"] = synced(calc.run)
        check(proj.shape == (n_frames, 2) and bool(np.isfinite(proj).all())
              and float(np.abs(proj).max()) <= 1 + 1e-5,
              f"{cv} projection finite in [-1, 1], shape {proj.shape}")
        if cv != "pca":
            ev = np.asarray(calc.eigenvalues_)
            check(bool(((ev > 0) & (ev <= 1 + 1e-4)).all()), f"{cv} eigenvalues {ev}")
            out[f"{cv}_eigenvalues"] = ev.tolist()
        linear[cv] = calc
        log(f"[{card}] {cv} at {n_frames} x {len(kept)} on the card: compute_cv "
            f"{out[f'{cv}_compute_cv_s'] * 1e3:.1f} ms, run() "
            f"{out[f'{cv}_run_s'] * 1e3:.1f} ms (data to the calculator "
            f"{out[f'{cv}_set_data_s'] * 1e3:.1f} ms)")

    # 2. A colvars file: time + every feature, COLVARS_FRAMES frames.
    path = os.path.join(tmp, "colvars.dat")
    rows = features[:COLVARS_FRAMES]
    data = np.column_stack([np.arange(COLVARS_FRAMES, dtype=np.float32), rows])
    _, out["colvars_write_s"] = synced(lambda: write_colvars(
        path, data, ["time"] + labels, fmt=COLVARS_FMT))
    out["colvars_mb"] = os.path.getsize(path) / 1e6
    (read_back, names), out["colvars_read_s"] = synced(lambda: read_features_matrix(path))
    out["colvars_write_mb_s"] = out["colvars_mb"] / out["colvars_write_s"]
    out["colvars_read_mb_s"] = out["colvars_mb"] / out["colvars_read_s"]
    check(names == labels and read_back.shape == rows.shape,
          f"colvars read back: {read_back.shape} columns {len(names)}")
    out["colvars_max_abs_err"] = float(np.abs(read_back - rows).max())
    log(f"[{card}] colvars {COLVARS_FRAMES} x {data.shape[1]} ({out['colvars_mb']:.1f} MB): "
        f"write {out['colvars_write_s']:.2f} s ({out['colvars_write_mb_s']:.1f} MB/s), "
        f"read {out['colvars_read_s']:.2f} s ({out['colvars_read_mb_s']:.1f} MB/s), "
        f"max err {out['colvars_max_abs_err']:.3g}")
    check(out["colvars_max_abs_err"] <= COLVARS_TOL,
          f"colvars values within {COLVARS_TOL} ({out['colvars_max_abs_err']})")

    # 3. The Filter on the file against the main path's screen on the same
    # values (those the file holds).
    flt, out["filter_file_s"] = synced(lambda: Filter(
        {"std_quantile": STD_QUANTILE, "diptest_significance_level": None}, [path],
        output_dir=os.path.join(tmp, "filter"), device=device).run())
    keep = quantile_mask(standard_deviation(read_back, device=device), STD_QUANTILE)
    want = [lab for lab, k in zip(labels, keep) if k]
    out["filter_file_kept"] = len(flt)
    out["filter_file_in_main_path_kept"] = len(set(flt) & set(kept))
    log(f"[{card}] Filter on the file {out['filter_file_s']:.2f} s ({len(flt)} kept, "
        f"{out['filter_file_in_main_path_kept']} of them in the main path's {len(kept)})")
    check(flt == want, f"Filter on the file keeps the main path's screen "
          f"({len(flt)} vs {len(want)})")
    col_index = {lab: i for i, lab in enumerate(labels)}
    file_kept = read_back[:, [col_index[lab] for lab in kept]]

    # 4. Streaming TICA and HTICA from the file against in-memory on the
    # same frames, and both against a float64 solve. HTICA takes the first
    # 580 features: 10 subspaces of 58, blocked alike by the streaming path
    # (equal subspaces) and in memory (split_subspaces).
    for cv, names_cv, subspaces in (("tica", kept, 1),
                                    ("htica", kept[:HTICA_STREAM_FEATURES],
                                     LINEAR_CONFIG["num_subspaces"])):
        cols = [col_index[lab] for lab in names_cv]
        stream = linear_calculator(cv, os.path.join(tmp, "stream"), device,
                                   streaming=True)
        _, out[f"{cv}_stream_load_s"] = synced(
            lambda: stream.load_training_data([path], features_list=names_cv))
        check(stream._streaming, f"{cv} streams")
        (got, _), out[f"{cv}_stream_run_s"] = synced(stream.run)
        mems = []
        for data in (read_back[:, cols], with_ulp_noise(read_back[:, cols])):
            mem = linear_calculator(cv, os.path.join(tmp, "mem"), device)
            mem._set_training_data(data, np.zeros(COLVARS_FRAMES, np.int64), names_cv)
            mems.append((mem, mem.run()[0]))
        (mem, want_proj), (_, jitter) = mems
        ev64, proj64 = float64_linear_cv(read_back[:, cols], subspaces, device)
        spread = float(np.abs(align_signs(jitter, want_proj) - want_proj).max())
        ev_err = float(np.abs(np.asarray(stream.eigenvalues_) - mem.eigenvalues_).max())
        out[f"{cv}_stream_eigenvalues"] = np.asarray(stream.eigenvalues_).tolist()
        out[f"{cv}_stream_eigenvalue_err"] = ev_err
        out[f"{cv}_stream_projection_err"] = float(
            np.abs(align_signs(got, want_proj) - want_proj).max())
        out[f"{cv}_stream_ulp_noise_spread"] = spread
        out[f"{cv}_float64_eigenvalues"] = ev64.tolist()
        for name, calc, proj in (("stream", stream, got), ("mem", mem, want_proj)):
            out[f"{cv}_{name}_float64_err"] = float(
                np.abs(align_signs(proj, proj64) - proj64).max())
            out[f"{cv}_{name}_float64_eigenvalue_err"] = float(
                np.abs(np.asarray(calc.eigenvalues_) - ev64).max())
        out[f"{cv}_c0_condition"] = c0_condition(mem)
        c0_err = streamed_c0_errors(stream, read_back[:, cols], subspaces)
        out[f"{cv}_streamed_c0_rel_err"] = c0_err["streamed"]
        out[f"{cv}_float32_product_c0_rel_err"] = c0_err["float32_product"]
        log(f"[{card}] streaming {cv} level-1 C0 against float64: streamed moments "
            f"{c0_err['streamed']:.3g}, one float32 batched product "
            f"{c0_err['float32_product']:.3g} (relative)")
        check(c0_err["streamed"] <= STREAMED_C0_RTOL,
              f"streamed {cv} C0 matches float64 ({c0_err['streamed']})")
        tol = conditioning_tol(spread)
        log(f"[{card}] streaming {cv} from the file ({len(names_cv)} features): load "
            f"{out[f'{cv}_stream_load_s']:.2f} s, run() {out[f'{cv}_stream_run_s']:.2f} s; "
            f"projection against in memory {out[f'{cv}_stream_projection_err']:.3g}, "
            f"against float64: streaming {out[f'{cv}_stream_float64_err']:.3g}, in memory "
            f"{out[f'{cv}_mem_float64_err']:.3g} (tolerance {tol:.3g}: one-ulp input "
            f"noise in memory {spread:.3g}; C0 condition number "
            f"{out[f'{cv}_c0_condition']:.3g}); eigenvalues against in memory {ev_err:.3g}")
        check(ev_err <= EIGVAL_TOL, f"streaming {cv} eigenvalues ({ev_err})")
        for key in ("stream_projection_err", "stream_float64_err", "mem_float64_err"):
            check(out[f"{cv}_{key}"] <= tol, f"{cv} {key} ({out[f'{cv}_{key}']})")
        for key in ("stream_float64_eigenvalue_err", "mem_float64_eigenvalue_err"):
            check(out[f"{cv}_{key}"] <= EIGVAL_TOL, f"{cv} {key} ({out[f'{cv}_{key}']})")
        linear[f"{cv}_stream"] = stream

    # 5. model.zip: save, load back, project the file.
    calc_deep.parent_output_path = os.path.join(tmp, "deep")
    calc_deep.ref_topology_path = ctx["pdb_path"]
    zips = {}
    for name, calc in (("deep_tica", calc_deep), ("pca", linear["pca"]),
                       ("tica", linear["tica"]), ("htica", linear["htica"])):
        calc.create_output_folders()
        _, out[f"{name}_save_s"] = synced(calc.save_model)
        zips[name] = os.path.join(str(calc.output_path), "model.zip")
        loaded, out[f"{name}_load_s"] = synced(lambda: CVCalculator.load(
            zips[name], os.path.join(tmp, "load", name), device=device))
        (proj, _), out[f"{name}_project_colvars_s"] = synced(
            lambda: loaded.project_colvars([path]))
        ref = calc.project_data(file_kept)
        out[f"{name}_zip_err"] = float(np.abs(proj - ref).max())
        log(f"[{card}] {name} model.zip: save {out[f'{name}_save_s'] * 1e3:.1f} ms, load "
            f"{out[f'{name}_load_s'] * 1e3:.1f} ms, project_colvars "
            f"{out[f'{name}_project_colvars_s']:.2f} s (err {out[f'{name}_zip_err']:.3g})")
        check(out[f"{name}_zip_err"] <= ZIP_TOL,
              f"{name} model.zip projects the file as the calculator ({out[f'{name}_zip_err']})")

    # 6. Serving a zip from the DCD (K1).
    for name in ("deep_tica", "tica"):
        pipeline, out[f"{name}_from_model_zip_s"] = synced(lambda: FramesToCV.from_model_zip(
            zips[name], ctx["pdb_path"], os.path.join(tmp, "serve", name), device=device))
        served, out[f"{name}_serve_s"] = synced(lambda: pipeline(ctx["frames"]))
        calc = calc_deep if name == "deep_tica" else linear["tica"]
        err = float(np.abs(served - calc.project_data(kept_features)).max())
        out[f"{name}_serve_err"] = err
        log(f"[{card}] from_model_zip {name}: load "
            f"{out[f'{name}_from_model_zip_s'] * 1e3:.1f} ms, serve {n_frames} frames "
            f"{out[f'{name}_serve_s'] * 1e3:.1f} ms (err {err:.3g})")
        check(served.shape == (n_frames, 2) and err <= PROJECTION_TOL,
              f"{name} served from model.zip matches project_data ({err})")
    out["launches"] = {st.name: st.launches for st in stats}
    check(out["launches"]["pair_distances_kernel"] > 0,
          "K1 was launched serving the model.zip")

    # 7. The card against the CPU, on a cut; and, on the card, the same
    # training from inputs with one ulp of noise (the conditioning floor).
    cut = kept_features[:CARD_CPU_FRAMES]
    noisy = with_ulp_noise(cut)
    for cv in ("pca", "tica", "htica"):
        runs = []
        for dev, data in ((device, cut), ("cpu", cut), (device, noisy)):
            calc = linear_calculator(cv, os.path.join(tmp, f"cut_{dev}"), dev)
            calc._set_training_data(data, None, kept)
            runs.append((calc.run()[0], calc.eigenvalues_))
        (on_card, ev_card), (host, ev_host), (jitter, _) = runs
        err = float(np.abs(align_signs(on_card, host) - host).max())
        out[f"{cv}_card_cpu_err"] = err
        out[f"{cv}_ulp_noise_spread"] = float(
            np.abs(align_signs(jitter, on_card) - on_card).max())
        log(f"[{card}] {cv} on {CARD_CPU_FRAMES} frames, card against CPU: {err:.3g} "
            f"(one-ulp input noise on the card: {out[f'{cv}_ulp_noise_spread']:.3g})")
        tol = conditioning_tol(out[f"{cv}_ulp_noise_spread"])
        check(err <= tol, f"{cv} on the card matches the CPU ({err}, tolerance {tol:.3g})")
        if cv != "pca":
            ev_err = float(np.abs(ev_card - ev_host).max())
            out[f"{cv}_card_cpu_eigenvalue_err"] = ev_err
            check(ev_err <= EIGVAL_TOL, f"{cv} eigenvalues on the card match the CPU "
                                        f"({ev_err})")
    del file_kept, read_back
    torch.cuda.empty_cache()
    log(json.dumps(out))
    return out, linear


def check_autoencoder_training(calc, cv: str, out: dict) -> None:
    """Finite losses in every try; the selected try's reconstruction fell;
    the VAE annealed its KL weight and kept its post-annealing best; the
    projection of the training data finite in [-1, 1]."""
    for try_num, r in calc.try_results:
        for key in ("train_loss", "valid_loss"):
            check(bool(np.isfinite(r.metrics[key]).all()),
                  f"{cv} try {try_num} {key} finite")
    recon = calc.metrics["valid_loss" if cv == "ae" else "valid_reconstruction_loss"]
    check(recon[-1] < recon[0], f"{cv} selected try's reconstruction fell "
                                f"({recon[0]} -> {recon[-1]})")
    if cv == "vae":
        beta = calc.metrics["beta"]
        check(beta[0] == 1e-6 and beta[-1] > 9e-3, f"vae KL annealing ({beta})")
        check(all(r.description == "best post-annealing" for _, r in calc.try_results),
              "every vae try kept its post-annealing best")
    proj = calc.project_data(calc.training_data)
    check(bool(np.isfinite(proj).all()) and float(np.abs(proj).max()) <= 1 + 1e-5,
          f"{cv} projection finite in [-1, 1]")
    out[f"{cv}_tries"] = [{"try": n, "score": r.score, "best_epoch": r.best_epoch,
                           "description": r.description} for n, r in calc.try_results]
    out[f"{cv}_selected_score"] = calc.cv_score


def check_batchnorm_fold(calc, out: dict) -> None:
    """The batchnorm AE: the fold run again on the card (timed) gives the
    same parameters; the folded net projects the training set as the
    batchnorm net normalized with the statistics of every training row."""
    import torch

    from deep_cartograph_torch.models.networks import stack_from_architecture

    folded, arch = calc.params, calc.architecture
    best = next(r for _, r in calc.try_results if r.score == calc.cv_score)
    unfolded = calc.build_architecture_dict()
    check(all(unfolded["encoder_options"]["batchnorm"][:3])
          and not any(arch["encoder_options"]["batchnorm"]),
          "the batchnorm flags are cleared by the fold")
    calc.architecture, calc.params = unfolded, best.params
    _, out["bn_fold_s"] = synced(calc._fold_batchnorm_for_eval)
    check(all(torch.equal(calc.params[k], folded[k]) for k in folded)
          and set(calc.params) == set(folded), "the fold is deterministic")
    calc.architecture, calc.params = arch, folded
    stack = stack_from_architecture(calc.build_architecture_dict()).to(calc.device)
    with torch.no_grad():
        latent = stack({k: v[None] for k, v in best.params.items()},
                       calc.training_data[None])[0].cpu().numpy()
    want = (latent - calc.post_mean) / calc.post_range
    out["bn_fold_err"] = float(np.abs(calc.project_data(calc.training_data) - want).max())
    check(out["bn_fold_err"] <= BN_FOLD_TOL,
          f"the folded AE projects as the batchnorm net ({out['bn_fold_err']})")


def evaluate_combine_chain(text: str, columns: dict) -> dict:
    """The COMBINE actions of a PLUMED input, in order, on `columns` (label
    -> values): each is sum_i c_i (arg_i - p_i), as PLUMED computes it."""
    values = dict(columns)
    for line in text.splitlines():
        label, sep, rest = line.partition(": COMBINE ")
        if not sep:
            continue
        kv = dict(item.split("=", 1) for item in rest.split())
        args = kv["ARG"].split(",")
        coeffs = [float(c) for c in kv.get("COEFFICIENTS", ",".join(["1"] * len(args))).split(",")]
        params = [float(p) for p in kv.get("PARAMETERS", ",".join(["0"] * len(args))).split(",")]
        values[label] = sum(c * (values[a] - p) for a, c, p in zip(args, coeffs, params))
    return values


def check_plumed_files(name: str, calc, folder: str, ctx: dict, out: dict) -> None:
    """The unbiased and biased PLUMED zips of `calc`: a non-linear CV's
    TorchScript weights run on the card, a linear CV's COMBINE chain
    evaluated on the feature matrix (float64), each against the
    calculator's projection of the main path's kept features."""
    import zipfile

    import torch

    cv = calc.cv_name
    kept_features, kept = ctx["kept_features"], ctx["kept"]
    zips = sorted(f for f in os.listdir(folder) if f.endswith(".zip"))
    check(zips == [f"plumed_{cv}_biased.zip", f"plumed_{cv}_unbiased.zip"],
          f"{name} PLUMED zips ({zips})")
    with zipfile.ZipFile(os.path.join(folder, zips[1])) as zf:
        members = zf.namelist()
        text = zf.read(f"plumed_input_{cv}.dat").decode()
        weights = zf.read(f"{cv}_weights.pt") if f"{cv}_weights.pt" in members else None
    want = calc.project_data(kept_features)
    if calc.get_cv_type() == "non-linear":
        path = os.path.join(folder, f"{cv}_weights.pt")
        with open(path, "wb") as fh:
            fh.write(weights)
        module = torch.jit.load(path, map_location=calc.device)
        with torch.no_grad():
            got = module(kept_features).cpu().numpy()
        key, tol = f"{name}_plumed_torchscript_err", TORCHSCRIPT_TOL
    else:
        columns = {lab: kept_features[:, i].double() for i, lab in enumerate(kept)}
        values = evaluate_combine_chain(text, columns)
        got = torch.stack([values[f"norm_{cv}_{i}"] for i in range(2)], 1).cpu().numpy()
        key, tol = f"{name}_plumed_combine_err", COMBINE_TOL
    out[key] = float(np.abs(got - want).max())
    check(got.shape == want.shape and out[key] <= tol,
          f"{name} PLUMED input computes the projection ({key} {out[key]})")


def autoencoders(calc_deep, linear: dict, ctx: dict, tmp: str, stats, card: str,
                 device="cuda") -> dict:
    """Phase 6 (the kernels' counts zeroed before and read after):

    1. an AE and a VAE trained at the main path's width and settings, all
       tries as one batched program (total, per epoch, tries);
    2. an AE with batchnorm after every hidden layer, BN_EPOCHS epochs: its
       fold, run again on the card, against the unfolded net;
    3. the three saved as model.zip, loaded back, and served from the DCD by
       FramesToCV.from_model_zip (K1), against project_data;
    4. write_plumed_files for the six families with the default bias, and
       for the AE with the RMSD restraint on two waypoints (the first and
       last frames);
    5. the AE on the card against the CPU on CARD_CPU_FRAMES frames: with
       leaky_relu (the losses held, the projection within the card's own
       one-ulp spread) and with tanh (the losses and the projection held).
    """
    import copy
    import zipfile

    import torch

    from deep_cartograph_torch.config.schemas import train_colvars_config
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.cv.base import CVCalculator
    from deep_cartograph_torch.deploy import FramesToCV

    kept_features, kept = ctx["kept_features"], ctx["kept"]
    n_frames = kept_features.shape[0]
    bias = train_colvars_config()["common"]["bias"]
    out: dict = {}
    for st in stats:
        st.launches = 0

    # 1. AE and VAE at full width.
    bn_config = copy.deepcopy(AUTOENCODER_CONFIG)
    bn_config["architecture"]["encoder"]["batchnorm"] = [True] * 3
    bn_config["training"]["general"]["max_epochs"] = BN_EPOCHS
    calcs = {}
    for name, cv, config in (("ae", "ae", AUTOENCODER_CONFIG),
                             ("vae", "vae", AUTOENCODER_CONFIG),
                             ("bn_ae", "ae", bn_config)):
        calc = cv_calculators_map[cv](config, os.path.join(tmp, name), device=device)
        _, out[f"{name}_set_data_s"] = synced(lambda: calc._set_training_data(
            kept_features, np.zeros(n_frames, np.int64), kept))
        trained, out[f"{name}_train_s"] = synced(calc.train)
        check(trained, f"{name} training produced a valid model")
        _, out[f"{name}_normalize_cv_s"] = synced(calc.normalize_cv)
        if name != "bn_ae":
            check_autoencoder_training(calc, cv, out)
        calcs[name] = calc
        log(f"[{card}] {name} at {n_frames} x {len(kept)}: train "
            f"{out[f'{name}_train_s']:.3f} s for {calc.num_tries} tries x "
            f"{calc.max_epochs} epochs at most, "
            f"post-normalization {out[f'{name}_normalize_cv_s']:.3f} s")

    # 2. The batchnorm fold.
    check_batchnorm_fold(calcs["bn_ae"], out)
    log(f"[{card}] batchnorm AE fold {out['bn_fold_s'] * 1e3:.1f} ms, folded against "
        f"the batchnorm net on all {n_frames} rows {out['bn_fold_err']:.3g}")

    # 3. model.zip: save, load, serve from the DCD (K1).
    for name, calc in calcs.items():
        calc.ref_topology_path = ctx["pdb_path"]
        calc.create_output_folders()
        _, out[f"{name}_save_s"] = synced(calc.save_model)
        path = os.path.join(str(calc.output_path), "model.zip")
        loaded, out[f"{name}_load_s"] = synced(lambda: CVCalculator.load(
            path, os.path.join(tmp, "load", name), device=device))
        want = calc.project_data(kept_features)
        out[f"{name}_loaded_err"] = float(np.abs(loaded.project_data(kept_features)
                                                 - want).max())
        pipeline, out[f"{name}_from_model_zip_s"] = synced(lambda: FramesToCV.from_model_zip(
            path, ctx["pdb_path"], os.path.join(tmp, "serve", name), device=device))
        served, out[f"{name}_serve_s"] = synced(lambda: pipeline(ctx["frames"]))
        out[f"{name}_serve_err"] = float(np.abs(served - want).max())
        log(f"[{card}] {name} model.zip: save {out[f'{name}_save_s'] * 1e3:.1f} ms, load "
            f"{out[f'{name}_load_s'] * 1e3:.1f} ms (err {out[f'{name}_loaded_err']:.3g}); "
            f"from_model_zip {out[f'{name}_from_model_zip_s'] * 1e3:.1f} ms, serve "
            f"{n_frames} frames {out[f'{name}_serve_s'] * 1e3:.1f} ms (err "
            f"{out[f'{name}_serve_err']:.3g})")
        check(out[f"{name}_loaded_err"] <= ZIP_TOL, f"{name} loaded zip projects alike")
        check(served.shape == (n_frames, 2) and out[f"{name}_serve_err"] <= ZIP_TOL,
              f"{name} served from model.zip matches project_data")
    out["launches"] = {st.name: st.launches for st in stats}
    check(out["launches"]["pair_distances_kernel"] >= len(calcs),
          "K1 was launched serving every new model.zip")

    # 4. The PLUMED files of the six families, then the RMSD restraint.
    families = {"pca": linear["pca"], "tica": linear["tica"], "htica": linear["htica"],
                "deep_tica": calc_deep, "ae": calcs["ae"], "vae": calcs["vae"]}
    for name, calc in families.items():
        calc.bias = copy.deepcopy(bias)
        folder = os.path.join(tmp, "plumed", name)
        os.makedirs(folder)
        _, out[f"{name}_plumed_s"] = synced(lambda: calc.write_plumed_files(
            ctx["pdb_path"], folder))
        check_plumed_files(name, calc, folder, ctx, out)
    waypoints = []
    for k, frame in enumerate((ctx["frames"][0], ctx["frames"][-1])):
        waypoints.append(os.path.join(tmp, f"waypoint_{k}.pdb"))
        write_ca_pdb(waypoints[-1], frame)
    calc = calcs["ae"]
    calc.bias = dict(copy.deepcopy(bias), add_rmsd_restraint=True)
    folder = os.path.join(tmp, "plumed", "ae_rmsd")
    os.makedirs(folder)
    _, out["ae_rmsd_plumed_s"] = synced(lambda: calc.write_plumed_files(
        ctx["pdb_path"], folder, waypoints))
    with zipfile.ZipFile(os.path.join(folder, "plumed_ae_biased.zip")) as zf:
        text = zf.read("plumed_input_ae_opes_metad.dat").decode()
        reference = zf.read("rmsd_restraint_reference.pdb").decode()
    marked = sum(float(line[54:60]) > 0 for line in reference.splitlines()
                 if line.startswith("ATOM"))
    out["rmsd_reference_atoms"] = marked
    check("rmsd_restraint: RMSD REFERENCE=rmsd_restraint_reference.pdb" in text
          and "UPPER_WALLS ARG=rmsd_restraint" in text and 0 < marked <= N_ATOMS,
          f"the AE's biased input carries the RMSD restraint ({marked} atoms)")
    log(f"[{card}] write_plumed_files (unbiased + opes_metad): "
        + ", ".join(f"{name} {out[f'{name}_plumed_s'] * 1e3:.1f} ms" for name in families)
        + f"; AE with the RMSD restraint {out['ae_rmsd_plumed_s'] * 1e3:.1f} ms "
        f"({marked} reference atoms); TorchScript against the projection "
        + ", ".join(f"{name} {out[f'{name}_plumed_torchscript_err']:.3g}"
                    for name in ("deep_tica", "ae", "vae"))
        + "; COMBINE chains "
        + ", ".join(f"{name} {out[f'{name}_plumed_combine_err']:.3g}"
                    for name in ("pca", "tica", "htica")))

    # 5. Training in detail, and the card against the CPU.
    for cv in ("ae", "vae"):
        breakdown = training_breakdown(cv, AUTOENCODER_CONFIG, calcs[cv])
        out.update({f"{cv}_{k}": v for k, v in breakdown.items()})
        log(f"[{card}] {cv} training, {breakdown['epochs']} epochs of "
            f"{breakdown['steps_per_epoch']} steps: host syncs "
            f"{breakdown['host_syncs_train']} in all; under torch.profiler "
            f"{breakdown['profiled_sync_calls_per_step']:.2f} sync calls per step, a step "
            f"{breakdown['profiled_step_ms']:.3f} ms of host time launching "
            f"{breakdown['profiled_step_device_ms']:.3f} ms of card work "
            f"(card busy {breakdown['profiled_step_busy_share']:.1%} of the steps' "
            f"card windows)")
    tanh_config = copy.deepcopy(AUTOENCODER_CONFIG)
    tanh_config["architecture"]["encoder"]["activation"] = ["tanh"] * 3
    for name, config in (("leaky_relu", AUTOENCODER_CONFIG), ("tanh", tanh_config)):
        compare = card_against_cpu("ae", config, calcs["ae"], CARD_CPU_FRAMES,
                                   hold_projection=name == "tanh")
        out.update({f"ae_card_cpu_{name}_{k}": v for k, v in compare.items()})
        floor = (f" (held to {ULP_SPREAD_MULTIPLE} x the card's largest one-ulp spread; "
                 f"spreads over {AE_NOISE_SEEDS} seeds "
                 f"{', '.join(f'{sp:.3g}' for sp in compare['ulp_noise_spread_card'])}, the "
                 f"gap above {compare['gap_rank_among_card_spreads']} of them; the CPU's "
                 f"{compare['ulp_noise_spread_cpu']:.3g})" if name == "leaky_relu" else "")
        log(f"[{card}] AE cut-down training, {name} ({CARD_CPU_FRAMES} frames, "
            f"{CUT_TRIES} tries, {CUT_EPOCHS} epochs): card {compare['card_s']:.3f} s, "
            f"CPU {compare['cpu_s']:.3f} s, losses within rel "
            f"{compare['loss_max_rel_diff']:.3g}, projection within "
            f"{compare['projection_max_abs_diff']:.3g}{floor}")
    torch.cuda.empty_cache()
    log(json.dumps(out))
    return out


def numpy_scores(x: np.ndarray, labels: np.ndarray):
    """Calinski-Harabasz, Davies-Bouldin and the silhouette in float64 numpy
    (the formulas of clustering.py; labels 0..k-1, every cluster non-empty)."""
    x = x.astype(np.float64)
    n, k = len(x), int(labels.max()) + 1
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    one_hot = np.eye(k)[labels]
    centers = one_hot.T @ x / counts[:, None]
    between = (counts * ((centers - x.mean(0)) ** 2).sum(1)).sum()
    within = ((x - centers[labels]) ** 2).sum()
    ch = (between / (k - 1)) / (within / (n - k))
    s = one_hot.T @ np.sqrt(((x - centers[labels]) ** 2).sum(1)) / counts
    center_d = np.sqrt(((centers[:, None] - centers[None]) ** 2).sum(-1))
    np.fill_diagonal(center_d, np.inf)
    db = ((s[:, None] + s[None]) / center_d).max(1).mean()
    sums = np.empty((n, k))
    for start in range(0, n, 500):
        d = np.sqrt(((x[start:start + 500, None] - x[None]) ** 2).sum(-1))
        sums[start:start + 500] = d @ one_hot
    a = sums[np.arange(n), labels] / np.maximum(counts[labels] - 1, 1)
    other = sums / counts
    other[np.arange(n), labels] = np.inf
    b = other.min(1)
    sil = np.where(counts[labels] > 1, (b - a) / np.maximum(a, b), 0.0)
    return ch, db, sil.mean()


def trajectory_inputs(coords: np.ndarray, ctx: dict, tmp: str, card: str,
                      device="cuda") -> dict:
    """Phase 7 (a): the main path's frames as XTC through the port's codec,
    counted, decoded and featurized (K1), once as one trajectory and once
    as three of uneven length through shared chunks."""
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.io.traj import iter_frame_chunks
    from deep_cartograph_torch.io.xtc import count_xtc_frames, read_xtc, write_xtc

    out: dict = {}
    n_frames = coords.shape[0]
    xtc = os.path.join(tmp, "traj.xtc")
    t0 = time.perf_counter()
    write_xtc(xtc, coords)
    out["xtc_write_s"] = time.perf_counter() - t0
    out["xtc_bytes"] = os.path.getsize(xtc)
    t0 = time.perf_counter()
    counted = count_xtc_frames(xtc)
    out["xtc_count_s"] = time.perf_counter() - t0
    check(counted == n_frames, f"count_xtc_frames: {counted} frames")
    t0 = time.perf_counter()
    decoded = sum(block.shape[0] for block in iter_frame_chunks(xtc, CHUNK))
    out["xtc_decode_s"] = time.perf_counter() - t0
    check(decoded == n_frames, f"iter_frame_chunks decoded {decoded} frames")

    parts = np.split(coords, list(TRAJ_SPLITS))
    paths = [os.path.join(tmp, f"part{i}.xtc") for i in range(len(parts))]
    for path, part in zip(paths, parts):
        write_xtc(path, part)

    labels = make_labels(N_ATOMS)
    featurizer = Featurizer(Topology.from_pdb(ctx["pdb_path"]), labels, device=device)
    features, out["xtc_featurize_s"] = synced(
        lambda: featurizer.featurize_trajectory(xtc, frame_chunk=CHUNK), device)
    split, out["xtc_featurize_trajectories_s"] = synced(
        lambda: featurizer.featurize_trajectories(paths, frame_chunk=CHUNK), device)

    check(features.shape == (n_frames, len(labels)), f"XTC features {features.shape}")
    # XTC keeps 0.01 Angstrom: two consecutive atoms of the synthetic helix
    # (0.73 Angstrom apart at rest) can land on the same grid point, and a
    # dihedral over them is NaN, in numpy as in the port.
    out["xtc_nan_features"] = int(np.isnan(features).sum())
    rows = np.arange(0, n_frames, XTC_CHECK_STRIDE)
    ref = numpy_features(read_xtc(xtc)[rows], labels)
    check(np.array_equal(np.isnan(features[rows]), np.isnan(ref)),
          "XTC features are NaN where numpy's are")
    out["xtc_features_err_vs_numpy"] = float(np.nanmax(np.abs(features[rows] - ref)))
    check(out["xtc_features_err_vs_numpy"] <= XTC_FEATURES_TOL,
          f"XTC features match numpy within {XTC_FEATURES_TOL}")
    check([len(p) for p in split] == [len(p) for p in parts]
          and np.array_equal(np.concatenate(split), features, equal_nan=True),
          "three trajectories through shared chunks equal the single one, in order")
    out["xtc_features"] = features
    log(f"[{card}] XTC ({n_frames} frames, {out['xtc_bytes'] / 1e6:.1f} MB): write "
        f"{out['xtc_write_s']:.3f} s, count {out['xtc_count_s'] * 1e3:.1f} ms, decode "
        f"{n_frames / out['xtc_decode_s']:.0f} frames/s ({out['xtc_decode_s']:.3f} s), "
        f"featurize {n_frames / out['xtc_featurize_s']:.0f} frames/s "
        f"({out['xtc_featurize_s']:.3f} s); as {len(paths)} trajectories "
        f"({', '.join(str(len(p)) for p in parts)} frames) "
        f"{out['xtc_featurize_trajectories_s']:.3f} s, equal to the single one; "
        f"features within {out['xtc_features_err_vs_numpy']:.3g} of numpy; "
        f"{out['xtc_nan_features']} NaN dihedral values (coincident atoms)")
    return out


def clustering(calc, ctx: dict, xtc_features: np.ndarray, card: str,
               device="cuda") -> dict:
    """Phase 7 (b): traj_cluster's clustering of the main path's projected
    deep-TICA values (n x 2, float32): the k-means scan, the scores,
    HDBSCAN, the hierarchical scan on a cut, the centroid marking and the
    nearest-neighbour assignment of the XTC trajectory's projection."""
    import torch

    from deep_cartograph_torch.cluster import clustering as cl

    cv = np.ascontiguousarray(ctx["cv"], dtype=np.float32)
    n = cv.shape[0]
    out: dict = {}

    # k-means over the search interval, n_init restarts batched
    (labels, centroids), out["kmeans_scan_s"] = synced(
        lambda: cl.optimize_clustering(cv, KMEANS_SETTINGS, device=device), device)
    k = len(centroids)
    out["kmeans_k"] = k
    syncs = count_syncs(lambda: cl.kmeans_clustering(cv, k, KMEANS_SETTINGS["n_init"],
                                                     device=device)) \
        if device == "cuda" else {}
    lloyd = {line: c for line, c in syncs.items() if "clustering.py" in line}
    out["kmeans_host_syncs"] = dict(syncs)
    out["kmeans_lloyd_host_reads"] = max(lloyd.values(), default=0)
    # The labels are the card's centroids' nearest assignment, in float32 numpy.
    d2 = ((cv[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    check(np.array_equal(d2.argmin(1), labels),
          "the card's k-means labels are its centroids' nearest assignment")
    # Lloyd stops once every centre moves by at most 1e-3 (squared shift <=
    # 1e-6), which is not a fixed point: a warm start from the card's
    # centroids may go on moving boundary points. The CPU's warm start must
    # equal the card's, and its change to the card's labels is recorded.
    back, back_centers = cl.kmeans_clustering(cv, k, 1, initial_centroids=centroids,
                                              device="cpu")
    card_back, card_centers = cl.kmeans_clustering(cv, k, 1, initial_centroids=centroids,
                                                   device=device)
    out["kmeans_cpu_warm_start_changed"] = int((back != labels).sum())
    out["kmeans_warm_start_card_cpu_diff"] = int((back != card_back).sum())
    out["kmeans_warm_start_centroid_err"] = float(np.abs(back_centers - card_centers).max())
    check(out["kmeans_warm_start_card_cpu_diff"] == 0
          and out["kmeans_warm_start_centroid_err"] <= 1e-5,
          "a warm start from the card's centroids gives the same labels on the CPU "
          "as on the card, centroids within 1e-5")
    check(labels.shape == (n,) and centroids.shape == (k, 2)
          and 3 <= k <= 10 and np.isfinite(centroids).all(), f"k-means scan: k={k}")
    mask, out["find_centroids_s"] = synced(
        lambda: cl.find_centroids(cv, centroids, device=device), device)
    check(0 < mask.sum() <= k, f"find_centroids marked {mask.sum()} samples")

    # the scores at full depth, and on a cut against float64 numpy
    scores, out["scores_s"] = synced(
        lambda: cl.clustering_scores(cv, labels, device=device), device)
    out["scores"] = scores
    cut = np.arange(0, n, max(1, n // SCORES_CUT))[:SCORES_CUT]
    _, cut_labels = np.unique(labels[cut], return_inverse=True)
    got = cl.clustering_scores(cv[cut], cut_labels, device=device)
    want = numpy_scores(cv[cut], cut_labels)
    out["scores_cut_max_rel_err"] = float(max(abs(g - w) / abs(w) for g, w in zip(got, want)))
    check(out["scores_cut_max_rel_err"] <= SCORES_RTOL,
          f"scores on {len(cut)} rows match float64 numpy within rel {SCORES_RTOL}")

    # HDBSCAN: the card against the port's CPU path on a cut, then full depth
    hcut = np.arange(0, n, max(1, n // HDBSCAN_CUT))[:HDBSCAN_CUT]
    (h_labels, h_centroids), out["hdbscan_cut_s"] = synced(
        lambda: cl.hdbscan_clustering(cv[hcut], **HDBSCAN_SETTINGS, device=device), device)
    t0 = time.perf_counter()
    cpu_labels, cpu_probs = cl.hdbscan_fit(cv[hcut], **HDBSCAN_SETTINGS, device="cpu")
    out["hdbscan_cut_cpu_s"] = time.perf_counter() - t0
    card_labels, card_probs = cl.hdbscan_fit(cv[hcut], **HDBSCAN_SETTINGS, device=device)
    cpu_centroids = cl.weighted_centroids(cv[hcut], cpu_labels, cpu_probs)
    check(np.array_equal(h_labels, cpu_labels) and np.array_equal(card_labels, cpu_labels),
          f"HDBSCAN on {len(hcut)} rows: card labels equal the CPU's")
    out["hdbscan_cut_prob_err"] = float(np.abs(card_probs - cpu_probs).max())
    out["hdbscan_cut_centroid_err"] = float(np.abs(h_centroids - cpu_centroids).max()) \
        if len(cpu_centroids) else 0.0
    check(max(out["hdbscan_cut_prob_err"], out["hdbscan_cut_centroid_err"]) <= HDBSCAN_TOL,
          f"HDBSCAN probabilities and centroids within {HDBSCAN_TOL}")
    out["hdbscan_cut_clusters"] = int(cpu_labels.max()) + 1
    out["hdbscan_cut_noise"] = int((cpu_labels == -1).sum())
    deep = cv[np.arange(0, n, max(1, n // HDBSCAN_DEPTH))[:HDBSCAN_DEPTH]]
    out["hdbscan_rows"] = len(deep)
    data64 = torch.as_tensor(deep.astype(np.float64), device=device)
    core, out["hdbscan_core_s"] = synced(
        lambda: cl._core_distances(data64, HDBSCAN_SETTINGS["min_samples"]), device)
    mst, out["hdbscan_prim_s"] = synced(lambda: cl._prim_mst(data64, core), device)
    out["hdbscan_prim_steps"] = len(mst[1])
    (f_labels, f_centroids), out["hdbscan_s"] = synced(
        lambda: cl.hdbscan_clustering(deep, **HDBSCAN_SETTINGS, device=device), device)
    out["hdbscan_clusters"] = int(f_labels.max()) + 1
    out["hdbscan_noise"] = int((f_labels == -1).sum())
    check(f_labels.shape == (len(deep),)
          and f_centroids.shape == (out["hdbscan_clusters"], 2)
          and np.isfinite(f_centroids).all(), f"HDBSCAN on {len(deep)} rows")

    # hierarchical (complete linkage) over the search interval, on a cut
    hier = np.arange(0, n, max(1, n // HIERARCHICAL_CUT))[:HIERARCHICAL_CUT]
    (hl, hc), out["hierarchical_scan_s"] = synced(
        lambda: cl.optimize_clustering(cv[hier], HIERARCHICAL_SETTINGS, device=device),
        device)
    out["hierarchical_k"] = len(hc)
    check(hl.shape == (len(hier),) and 3 <= len(hc) <= 10,
          f"hierarchical scan on {len(hier)} rows: k={len(hc)}")

    # the XTC trajectory's projection assigned to its nearest clustered frame
    keep = np.isin(make_labels(N_ATOMS), ctx["kept"])
    new = np.asarray(calc.project_data(xtc_features[:, keep]), dtype=np.float32)
    finite = np.isfinite(new).all(1)
    out["nearest_neighbor_nan_rows"] = int((~finite).sum())
    new = np.ascontiguousarray(new[finite])
    nearest, out["nearest_neighbor_s"] = synced(
        lambda: cl.assign_nearest_neighbor(new, cv, device=device), device)
    rows = np.random.default_rng(SEED).choice(len(new), NN_SAMPLE, replace=False)
    d2 = ((new[rows, None].astype(np.float64) - cv[None].astype(np.float64)) ** 2).sum(-1)
    best = d2.argmin(1)
    excess = d2[np.arange(NN_SAMPLE), nearest[rows]] - d2[np.arange(NN_SAMPLE), best]
    bound = NN_ULPS * np.finfo(np.float32).eps * (
        (new[rows].astype(np.float64) ** 2).sum(1) + (cv[best].astype(np.float64) ** 2).sum(1))
    out["nearest_neighbor_exact_share"] = float((nearest[rows] == best).mean())
    out["nearest_neighbor_max_excess_ulps"] = float(
        (excess / (bound / NN_ULPS)).max())
    check(nearest.shape == (len(new),) and bool((excess <= bound).all()),
          f"nearest neighbours of {NN_SAMPLE} rows: numpy's, or within {NN_ULPS} float32 "
          "ulps of its distance")

    log(f"[{card}] k-means scan k={KMEANS_SETTINGS['search_interval']} x n_init "
        f"{KMEANS_SETTINGS['n_init']} on {n} x 2: {out['kmeans_scan_s']:.3f} s, chose "
        f"k={k}; one run's Lloyd host reads {out['kmeans_lloyd_host_reads']} "
        f"(syncs by line {out['kmeans_host_syncs']}); labels = the centroids' nearest; "
        f"a warm start from them: CPU = card ({out['kmeans_warm_start_card_cpu_diff']} "
        f"labels differ, centroids within {out['kmeans_warm_start_centroid_err']:.3g}), "
        f"{out['kmeans_cpu_warm_start_changed']} labels moved; find_centroids "
        f"{out['find_centroids_s'] * 1e3:.1f} ms")
    log(f"[{card}] scores at {n} rows {out['scores_s']:.3f} s "
        f"(CH {scores[0]:.6g}, DB {scores[1]:.6g}, silhouette {scores[2]:.6g}); on "
        f"{len(cut)} rows within rel {out['scores_cut_max_rel_err']:.3g} of float64 numpy")
    log(f"[{card}] HDBSCAN on {len(hcut)} rows: card {out['hdbscan_cut_s']:.3f} s, CPU "
        f"{out['hdbscan_cut_cpu_s']:.3f} s, labels equal ({out['hdbscan_cut_clusters']} "
        f"clusters, {out['hdbscan_cut_noise']} noise), probabilities within "
        f"{out['hdbscan_cut_prob_err']:.3g}, centroids within "
        f"{out['hdbscan_cut_centroid_err']:.3g}; on {out['hdbscan_rows']} rows "
        f"{out['hdbscan_s']:.3f} s "
        f"({out['hdbscan_clusters']} clusters, {out['hdbscan_noise']} noise): core "
        f"distances {out['hdbscan_core_s']:.3f} s, Prim's tree "
        f"{out['hdbscan_prim_steps']} steps {out['hdbscan_prim_s']:.3f} s")
    log(f"[{card}] hierarchical (complete) scan on {len(hier)} rows "
        f"{out['hierarchical_scan_s']:.3f} s, chose k={out['hierarchical_k']}; nearest "
        f"neighbours of {len(new)} points ({out['nearest_neighbor_nan_rows']} NaN rows "
        f"left out) among {n}: {out['nearest_neighbor_s']:.3f} s, "
        f"{out['nearest_neighbor_exact_share']:.1%} of {NN_SAMPLE} checked rows numpy's "
        f"argmin, the rest within {out['nearest_neighbor_max_excess_ulps']:.2f} ulps")
    return out


def phase7(calc, coords: np.ndarray, ctx: dict, tmp: str, stats, card: str,
           device="cuda") -> dict:
    """Phase 7: trajectory inputs and clustering, the kernels' counts zeroed
    before and read after."""
    for st in stats:
        st.launches = 0
    out = trajectory_inputs(coords, ctx, tmp, card, device)
    out.update(clustering(calc, ctx, out.pop("xtc_features"), card, device))
    out["launches"] = {st.name: st.launches for st in stats}
    if device == "cuda":
        check(out["launches"]["pair_distances_kernel"] > 0,
              "K1 featurized the XTC trajectories")
    log(json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 8: geometry analysis, augmentation, hydrogen bonds, Müller-Brown, UMAP
# ---------------------------------------------------------------------------

def numpy_kabsch_align(frames: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Every frame rigidly fitted onto `ref` in float64: SVD of the centred
    covariance, the proper rotation (det +1), apart from the port's code."""
    f, r = frames.astype(np.float64), ref.astype(np.float64)
    fc, rc = f.mean(1, keepdims=True), r.mean(0)
    U, _, Vt = np.linalg.svd(np.einsum("fai,aj->fij", f - fc, r - rc))
    V, Ut = np.swapaxes(Vt, 1, 2), np.swapaxes(U, 1, 2)
    V[:, :, 2] *= np.sign(np.linalg.det(V @ Ut))[:, None]
    return (f - fc) @ np.swapaxes(V @ Ut, 1, 2) + rc


def numpy_rmsf(frames: np.ndarray) -> np.ndarray:
    """Per-atom RMSF: aligned to frame 0, averaged, aligned to the average."""
    average = numpy_kabsch_align(frames, frames[0]).mean(0)
    aligned = numpy_kabsch_align(frames, average)
    return np.sqrt(((aligned - aligned.mean(0)) ** 2).sum(-1).mean(0))


def numpy_langevin(xi: np.ndarray, x_init, dt: float, kt: float) -> np.ndarray:
    """Overdamped Langevin steps on the Müller-Brown surface in float64
    (Müller & Brown 1979 parameters): the position after each step."""
    A = np.array([-200.0, -100.0, -170.0, 15.0])
    a, b, c = np.array([-1, -1, -6.5, 0.7]), np.array([0, 0, 11, 0.6]), \
        np.array([-10, -10, -6.5, 0.7])
    x0, y0 = np.array([1.0, 0.0, -0.5, -1.0]), np.array([0.0, 0.5, 1.5, 1.0])
    x, scale, path = np.array(x_init, np.float64), np.sqrt(2.0 * kt * dt), []
    for step in xi.astype(np.float64):
        dx, dy = x[0] - x0, x[1] - y0
        e = A * np.exp(a * dx ** 2 + b * dx * dy + c * dy ** 2)
        g = np.array([np.sum(e * (2 * a * dx + b * dy)), np.sum(e * (b * dx + 2 * c * dy))])
        x = x - np.clip(g, -1e3, 1e3) * dt + scale * step
        path.append(x)
    return np.asarray(path)


# The first Kabsch SVD of a process on the card, timed in a fresh process:
# the CUDA context first, then the first and a second batched SVD of the
# RMSD's shape.
_FIRST_SVD = """
import json, sys, time, torch
torch.zeros(1, device="cuda"); torch.cuda.synchronize()
h = torch.randn(int(sys.argv[1]), 3, 3, device="cuda"); torch.cuda.synchronize()
times = []
for _ in range(2):
    t0 = time.perf_counter(); torch.linalg.svd(h); torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
print(json.dumps({"first_svd_s": times[0], "second_svd_s": times[1]}))
"""


def first_svd_in_a_process(n_frames: int) -> dict:
    out = subprocess.run([sys.executable, "-c", _FIRST_SVD, str(n_frames)], check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def geometry(ctx: dict, tmp: str, card: str, device="cuda") -> dict:
    """Phase 8 (a): RMSD, RMSF and dRMSD (K1) of the main path's DCD against
    its first frame, held on every GEOM_CHECK_STRIDE-th frame to float64
    numpy and to the port on the CPU; the trajectory augmented to
    AUGMENTED_FRAMES frames by pchip and by akima, written as XTC and held
    to scipy on the same input."""
    from scipy.interpolate import Akima1DInterpolator, PchipInterpolator

    from deep_cartograph_torch.features.discovery import get_distance_labels
    from deep_cartograph_torch.geom.analysis import RMSD, RMSF, dRMSD
    from deep_cartograph_torch.geom.interpolate import interpolate_trajectory
    from deep_cartograph_torch.io.dcd import write_dcd
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.io.xtc import read_xtc

    pdb, dcd, frames = ctx["pdb_path"], ctx["dcd_path"], ctx["frames"]
    n_frames = frames.shape[0]
    top = Topology.from_pdb(pdb)
    ref = top.positions
    rows = np.arange(0, n_frames, GEOM_CHECK_STRIDE)
    sub = os.path.join(tmp, "every_nth.dcd")
    write_dcd(sub, frames[rows])
    out: dict = {}

    rmsd, out["rmsd_first_s"] = synced(
        lambda: RMSD(dcd, pdb, "name CA", "name CA", device=device), device)
    _, out["rmsd_second_s"] = synced(
        lambda: RMSD(dcd, pdb, "name CA", "name CA", device=device), device)
    check(rmsd.shape == (n_frames,) and bool(np.isfinite(rmsd).all()), "RMSD finite")
    out["rmsd_err_vs_numpy"] = float(np.abs(rmsd[rows] - np.sqrt(
        ((numpy_kabsch_align(frames[rows], ref) - ref) ** 2).sum(-1).mean(-1))).max())
    out["rmsd_err_vs_cpu"] = float(np.abs(
        rmsd[rows] - RMSD(sub, pdb, "name CA", "name CA", device="cpu")).max())
    check(max(out["rmsd_err_vs_numpy"], out["rmsd_err_vs_cpu"]) <= GEOM_TOL,
          f"RMSD within {GEOM_TOL} A of float64 numpy and of the CPU")

    (rmsf, residues), out["rmsf_s"] = synced(
        lambda: RMSF(dcd, pdb, "name CA", "name CA", device=device), device)
    check(len(rmsf) == len(residues) == N_ATOMS and bool(np.isfinite(rmsf).all()),
          "RMSF per residue")
    cut_rmsf = np.asarray(RMSF(sub, pdb, "name CA", "name CA", device=device)[0])
    out["rmsf_err_vs_numpy"] = float(np.abs(cut_rmsf - numpy_rmsf(frames[rows])).max())
    out["rmsf_err_vs_cpu"] = float(np.abs(
        cut_rmsf - np.asarray(RMSF(sub, pdb, "name CA", "name CA", device="cpu")[0])).max())
    check(max(out["rmsf_err_vs_numpy"], out["rmsf_err_vs_cpu"]) <= GEOM_TOL,
          f"RMSF within {GEOM_TOL} A of float64 numpy and of the CPU")

    drmsd, out["drmsd_s"] = synced(
        lambda: dRMSD(dcd, pdb, "name CA", 1, pdb, device=device), device)
    labels = get_distance_labels(top, {
        "first_selection": "name CA", "second_selection": "name CA", "first_stride": 1,
        "second_stride": 1, "skip_neigh_residues": True, "skip_bonded_atoms": True})
    want = numpy_features(frames[rows], labels) - numpy_features(ref[None], labels)
    out["drmsd_pairs"] = len(labels)
    out["drmsd_err_vs_numpy"] = float(np.abs(
        drmsd[rows] - np.sqrt((want ** 2).mean(1))).max())
    check(drmsd.shape == (n_frames,) and out["drmsd_err_vs_numpy"] <= DRMSD_TOL,
          f"dRMSD within {DRMSD_TOL} nm of float64 numpy")

    # augmentation (host numpy and scipy, the port's XTC writer)
    grid = np.arange(n_frames, dtype=np.float64)
    new_frames = np.sort(np.concatenate((grid, np.linspace(
        grid[0], grid[-1], AUGMENTED_FRAMES - n_frames + 2)[1:-1])))[::GEOM_CHECK_STRIDE]
    os.makedirs(os.path.join(tmp, "augmented"), exist_ok=True)
    for method, interpolator in (("pchip", lambda: PchipInterpolator(grid, frames, axis=0)),
                                 ("akima", lambda: Akima1DInterpolator(
                                     grid, frames, axis=0, method="makima"))):
        t0 = time.perf_counter()
        path, _ = interpolate_trajectory(pdb, dcd, AUGMENTED_FRAMES, interpolation_method=method,
                                         traj_format="xtc",
                                         output_path=os.path.join(tmp, "augmented"))
        out[f"augment_{method}_s"] = time.perf_counter() - t0
        got = read_xtc(path)
        check(got.shape == (AUGMENTED_FRAMES, N_ATOMS, 3), f"{method}: {got.shape} frames")
        out[f"augment_{method}_err_vs_scipy"] = float(np.abs(
            got[::GEOM_CHECK_STRIDE] - interpolator()(new_frames)).max())
        check(out[f"augment_{method}_err_vs_scipy"] <= XTC_GRID_TOL,
              f"{method} frames within {XTC_GRID_TOL} A of scipy (the XTC grid)")
    log(f"[{card}] RMSD of {n_frames} frames x {N_ATOMS} CA: first call "
        f"{out['rmsd_first_s']:.3f} s, second {out['rmsd_second_s']:.3f} s, within "
        f"{out['rmsd_err_vs_numpy']:.3g} A of float64 numpy, {out['rmsd_err_vs_cpu']:.3g} "
        f"of the CPU; RMSF {out['rmsf_s']:.3f} s (on every {GEOM_CHECK_STRIDE}th frame "
        f"within {out['rmsf_err_vs_numpy']:.3g} / {out['rmsf_err_vs_cpu']:.3g}); dRMSD "
        f"({out['drmsd_pairs']} pairs, K1) {out['drmsd_s']:.3f} s, within "
        f"{out['drmsd_err_vs_numpy']:.3g} nm of numpy")
    log(f"[{card}] augmentation {n_frames} -> {AUGMENTED_FRAMES} frames as XTC: pchip "
        f"{out['augment_pchip_s']:.2f} s, akima {out['augment_akima_s']:.2f} s; within "
        f"{out['augment_pchip_err_vs_scipy']:.3g} / {out['augment_akima_err_vs_scipy']:.3g}"
        f" A of scipy")
    return out


def hydrogen_bonds(tmp: str, card: str, device="cuda") -> dict:
    """Phase 8 (b): analyze_residue_hbonds on a backbone_coords peptide of
    HBOND_RESIDUES residues x HBOND_FRAMES frames; the card's events on every
    GEOM_CHECK_STRIDE-th frame held to a float64 numpy mask."""
    from deep_cartograph_torch.geom.hbonds import (
        analyze_residue_hbonds,
        hbond_mask,
        hbond_occupancy,
        hbond_triplets,
    )
    from deep_cartograph_torch.io.dcd import write_dcd
    from deep_cartograph_torch.io.topology import parse_pdb
    from deep_cartograph_torch.utils.demo_data import backbone_coords, write_backbone_pdb

    out: dict = {}
    t0 = time.perf_counter()
    coords, names, resnames, resids = backbone_coords(HBOND_RESIDUES, HBOND_FRAMES, SEED)
    out["hbond_generate_s"] = time.perf_counter() - t0
    out["hbond_coords_mb"] = coords.nbytes / 1e6
    pdb, dcd = os.path.join(tmp, "peptide.pdb"), os.path.join(tmp, "peptide.dcd")
    write_backbone_pdb(pdb, coords[0], names, resnames, resids)
    write_dcd(dcd, coords)
    (events, n_frames), out["hbond_s"] = synced(
        lambda: analyze_residue_hbonds(pdb, dcd, device=device, **HBOND_SETTINGS), device)
    s = HBOND_SETTINGS
    d_cut, a_cut = s["d_a_cutoff"], s["d_h_a_angle_cutoff"]
    trip = hbond_triplets(parse_pdb(pdb), coords[0], s["donors_sel"], s["hydrogens_sel"],
                          s["acceptors_sel"], s["first_selection"], s["second_selection"])
    _, out["hbond_mask_s"] = synced(
        lambda: hbond_mask(coords, *trip, d_cut, a_cut, device), device)
    out["hbond_triplets"] = len(trip[0])
    out["hbond_events"] = len(events["frame"])
    out["hbond_occupancy"] = hbond_occupancy(events, n_frames)

    # the card's events at the checked frames, as a (frames, triplets) mask
    rows = np.arange(0, n_frames, GEOM_CHECK_STRIDE)
    position = {t: i for i, t in enumerate(zip(*(v.tolist() for v in trip)))}
    at = events["frame"] % GEOM_CHECK_STRIDE == 0
    card_mask = np.zeros((len(rows), len(trip[0])), bool)
    cols = [position[t] for t in zip(events["donor_index"][at].tolist(),
                                      events["hydrogen_index"][at].tolist(),
                                      events["acceptor_index"][at].tolist())]
    card_mask[events["frame"][at] // GEOM_CHECK_STRIDE, cols] = True
    c = coords[rows].astype(np.float64)
    d, h, a = (c[:, idx] for idx in trip)
    dist = np.linalg.norm(a - d, axis=-1)
    v1, v2 = d - h, a - h
    angle = np.degrees(np.arccos(np.clip(np.sum(v1 * v2, -1) / (
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-12), -1.0, 1.0)))
    want = (dist <= d_cut) & (angle >= a_cut)
    edge = (np.abs(dist - d_cut) <= HBOND_EDGE_RTOL * d_cut) | \
        (np.abs(angle - a_cut) <= HBOND_EDGE_RTOL * a_cut)
    differ = card_mask != want
    out["hbond_checked_events"] = int(want.sum())
    out["hbond_differing_events"] = int(differ.sum())
    out["hbond_edge_entries"] = int(edge.sum())
    check(out["hbond_events"] > 0 and not (differ & ~edge).any(),
          f"H-bond events equal the float64 mask but within rel {HBOND_EDGE_RTOL} of a "
          f"cutoff ({out['hbond_differing_events']} differ)")
    log(f"[{card}] H-bonds, {HBOND_RESIDUES} residues x {n_frames} frames "
        f"({out['hbond_coords_mb']:.0f} MB of coordinates, generated in "
        f"{out['hbond_generate_s']:.2f} s): analyze_residue_hbonds {out['hbond_s']:.3f} s "
        f"({out['hbond_triplets']} triplets, {out['hbond_events']} events, occupancy "
        f"{out['hbond_occupancy']:.3f}), the mask alone {out['hbond_mask_s']:.3f} s; on "
        f"every {GEOM_CHECK_STRIDE}th frame {out['hbond_checked_events']} events, "
        f"{out['hbond_differing_events']} differ from float64 numpy "
        f"({out['hbond_edge_entries']} entries within rel {HBOND_EDGE_RTOL} of a cutoff)")
    return out


def muller_brown(card: str, device="cuda") -> dict:
    """Phase 8 (c): the Müller-Brown sampler at its defaults, timed; its
    first MB_CHECK_STEPS steps held to float64 numpy with the same noise
    (the seeded generator's block of draws)."""
    import inspect

    import torch

    from deep_cartograph_torch.data.muller_brown import basin_labels, sample_trajectory

    defaults = {k: v.default for k, v in
                inspect.signature(sample_trajectory).parameters.items()}
    n_steps = defaults["n_frames"] * defaults["stride"]
    out: dict = {}
    traj, out["mb_s"] = synced(lambda: sample_trajectory(device=device), device)
    gen = torch.Generator(device=device).manual_seed(defaults["seed"])
    xi = torch.randn((n_steps, 2), generator=gen, device=device)[:MB_CHECK_STEPS]
    want = numpy_langevin(xi.cpu().numpy(), defaults["x_init"], defaults["dt"],
                          defaults["kt"])[::defaults["stride"]]
    out["mb_steps"] = n_steps
    out["mb_err_vs_numpy"] = float(np.abs(traj[:len(want)] - want).max())
    out["mb_basins"] = len(np.unique(basin_labels(traj)))
    check(traj.shape == (defaults["n_frames"], 2) and bool(np.isfinite(traj).all())
          and float(np.abs(traj).max()) < 3.0, "Müller-Brown trajectory bounded")
    check(out["mb_err_vs_numpy"] <= MB_TOL,
          f"the first {MB_CHECK_STEPS} steps within {MB_TOL} of float64 numpy")
    log(f"[{card}] Müller-Brown {n_steps} steps ({defaults['n_frames']} frames x stride "
        f"{defaults['stride']}): {out['mb_s']:.2f} s, {n_steps / out['mb_s']:.0f} steps/s; "
        f"{out['mb_basins']} basins visited; the first {MB_CHECK_STEPS} steps within "
        f"{out['mb_err_vs_numpy']:.3g} of float64 numpy")
    return out


def numpy_draws(n: int):
    """Layout draws from numpy, the same for any device: per epoch, the
    acceptance uniforms and the negative samples."""
    def draws(epoch, n_edges):
        rng = np.random.default_rng([SEED, epoch])
        return rng.random(n_edges, dtype=np.float32), rng.integers(0, n, (n_edges, 5))
    return draws


def knn_against_numpy(idx, x64: np.ndarray, k: int, key: str, out: dict) -> int:
    """The kNN indices (n, k) of `x64`'s rows among themselves, held on
    UMAP_KNN_SAMPLE rows to float64 numpy: each reported neighbour's d2
    beyond the float64 one of its rank, in float32 ulps of |q|^2 + |x|^2
    (`{key}_max_excess_ulps`), within the float32 bound of the d2
    expansion (`knn_bound_ulps`; `{key}_max_excess_of_bound`). Returns the
    rows that are exactly numpy's."""
    n = len(x64)
    rows = np.random.default_rng(SEED).choice(n, UMAP_KNN_SAMPLE, replace=False)
    sq = (x64 ** 2).sum(1)
    got_idx = idx[rows].cpu().numpy()
    excess, of_bound, exact = [], [], 0
    for start in range(0, UMAP_KNN_SAMPLE, 100):
        r, got = rows[start:start + 100], got_idx[start:start + 100]
        d2 = sq[r, None] - 2 * x64[r] @ x64.T + sq[None, :]
        d2[np.arange(len(r)), r] = np.inf
        best = np.sort(d2, axis=1)[:, :k]
        mine = np.take_along_axis(d2, got, 1)
        exact += int((np.sort(np.argsort(d2, 1, kind="stable")[:, :k], 1)
                      == np.sort(got, 1)).all(1).sum())
        ulps = (mine - best) / (np.finfo(np.float32).eps * (sq[r, None] + sq[got]))
        excess.append(ulps)
        of_bound.append(ulps / knn_bound_ulps(sq[r], sq[got], sq.max(), x64.shape[1]))
    excess, of_bound = np.concatenate(excess), np.concatenate(of_bound)
    out[f"{key}_rows"] = n
    out[f"{key}_exact_rows"] = exact
    out[f"{key}_max_excess_ulps"] = float(excess.max())
    out[f"{key}_max_excess_of_bound"] = float(of_bound.max())
    check(bool((of_bound <= 1).all()),
          f"kNN of {UMAP_KNN_SAMPLE} of {n} rows: numpy's, or within the float32 bound of "
          f"the d2 expansion ({out[f'{key}_max_excess_ulps']:.3g} ulps, "
          f"{out[f'{key}_max_excess_of_bound']:.3g} of the bound)")
    return exact


def knn_bound_ulps(sq_q: np.ndarray, sq_got: np.ndarray, sq_max: float, d: int) -> np.ndarray:
    """The most that a float32 kNN by the d2 expansion may report beyond
    the exact neighbour of each rank, in the ulps of `knn_against_numpy`
    (eps32 (|q|^2 + |x|^2) of the reported neighbour x), per query row and
    rank. The expansion fl(fl(|q|^2 - 2 q.x) + |x|^2) of d-term sums errs
    by at most (2 d + 5) u S, S = |q|^2 + |x|^2, u = eps32 / 2: gamma_d S
    for the two norms, gamma_d 2 sum |q_i x_i| <= gamma_d S for the
    product (|q_i x_i| <= (q_i^2 + x_i^2) / 2), 4 u S for the two roundings
    of terms of size <= 2 S. The k-th smallest of values each within E of
    exact is within E of the exact k-th, so a reported neighbour's exact d2
    exceeds the exact one of its rank by at most 2 E, E taken at the
    largest |x|^2: 2 (2 d + 5) u (|q|^2 + max |x|^2)."""
    return (2 * d + 5) * (sq_q[:, None] + sq_max) / (sq_q[:, None] + sq_got)


def umap_cv(ctx: dict, tmp: str, card: str, device="cuda") -> dict:
    """Phase 8 (d): the UMAP CV at the main path's width through
    cv_calculators_map["umap"] (the schema's defaults, the main path's
    mean_std normalization, 2 components, 300 epochs): the fit's parts,
    transform, save, load and project_colvars timed; the kNN, sigma, one
    layout epoch and a fit on a cut held as the constants above say."""
    import torch

    from deep_cartograph_torch.config.schemas import cv_configuration, train_colvars_config
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.cv.base import CVCalculator
    from deep_cartograph_torch.cv.umap_cv import (
        UMAPModel,
        _knn,
        _smooth_knn,
        layout_epoch,
    )
    from deep_cartograph_torch.deploy import FramesToCV

    kept_features, kept, pdb = ctx["kept_features"], ctx["kept"], ctx["pdb_path"]
    n = kept_features.shape[0]
    config = cv_configuration(train_colvars_config(), "umap")
    config["features_normalization"] = TRAIN_CONFIG["features_normalization"]
    calc = cv_calculators_map["umap"](config, os.path.join(tmp, "umap_out"), device=device)
    calc.ref_topology_path = pdb
    calc._set_training_data(kept_features, None, kept)
    out: dict = {}
    (projection, labels), out["umap_run_s"] = synced(calc.run, device)
    out["umap_fit_s"] = dict(calc.cv.fit_seconds)
    check(projection.shape == (n, 2) and bool(np.isfinite(projection).all())
          and labels == ["UMAP 1", "UMAP 2"], "UMAP run(): finite (n, 2) projection")
    transformed, out["umap_transform_s"] = synced(
        lambda: calc.project_data(kept_features), device)
    check(transformed.shape == (n, 2) and bool(np.isfinite(transformed).all()),
          "transform of every frame finite")
    # the rest of run() is the save (normalize_cv and the labels take ~0)
    out["umap_save_s"] = out["umap_run_s"] - sum(calc.cv.fit_seconds.values())
    model = os.path.join(tmp, "umap_out", "umap", "model.zip")
    out["umap_zip_mb"] = os.path.getsize(model) / 1e6
    loaded, out["umap_load_s"] = synced(
        lambda: CVCalculator.load(model, os.path.join(tmp, "umap_load"), device=device), device)
    out["umap_zip_err"] = float(np.abs(
        loaded.project_data(kept_features[:2000]) - transformed[:2000]).max())
    check(out["umap_zip_err"] <= ZIP_TOL, "the loaded zip projects as the calculator")
    colvars = os.path.join(tmp, "colvars.dat")
    (from_file, _), out["umap_project_colvars_s"] = synced(
        lambda: loaded.project_colvars([colvars], [pdb]), device)
    check(from_file.shape == (COLVARS_FRAMES, 2) and bool(np.isfinite(from_file).all()),
          "project_colvars of phase 4's file")
    try:
        FramesToCV.from_model_zip(model, pdb, os.path.join(tmp, "umap_serve"), device=device)
        raise RuntimeError("check failed: FramesToCV.from_model_zip served a UMAP zip")
    except TypeError:
        pass

    # the kNN on UMAP_KNN_SAMPLE rows against float64 numpy, at n rows and
    # again on the first UMAP_KNN_CUT rows (other query tiles)
    x = calc._normalized(kept_features)
    k = calc.cv.n_neighbors
    (dists, idx), out["umap_knn_again_s"] = synced(lambda: _knn(x, x, k, True), device)
    x64 = calc.cv.training_data.astype(np.float64)
    exact = knn_against_numpy(idx, x64, k, "umap_knn", out)
    cut = UMAP_KNN_CUT
    _, cut_idx = _knn(x[:cut], x[:cut], k, True)
    knn_against_numpy(cut_idx, x64[:cut], k, f"umap_knn_{cut}", out)
    (rho, sigma), out["umap_sigma_again_s"] = synced(lambda: _smooth_knn(dists), device)
    d64, rho64, sigma64 = (v.double().cpu().numpy() for v in (dists, rho, sigma))
    total = np.exp(-np.maximum(d64 - rho64[:, None], 0.0) / sigma64[:, None]).sum(1)
    out["umap_sigma_max_rel_err"] = float(np.abs(total / np.log2(k) - 1).max())
    check(out["umap_sigma_max_rel_err"] <= SIGMA_RTOL,
          f"sigma solves sum exp(-(d - rho)/sigma) = log2(k) within rel {SIGMA_RTOL}")

    # one layout epoch from the fitted embedding: the card (LAYOUT_REPEATS
    # runs) against the CPU, from the same embedding, graph and draws
    heads, tails, weights = calc.cv.graph_
    uniform, negatives = numpy_draws(n)(0, len(heads))

    def one_epoch(dev, embedding=calc.cv.embedding_):
        return layout_epoch(
            torch.as_tensor(embedding, device=dev).clone(),
            *(torch.as_tensor(v, device=dev) for v in (heads, tails, weights, uniform)),
            torch.as_tensor(negatives, device=dev), 1.0, calc.cv.a, calc.cv.b
        ).cpu().numpy()

    on_card = [one_epoch(device) for _ in range(LAYOUT_REPEATS)]
    on_cpu = one_epoch("cpu")
    out["umap_edges"] = len(heads)
    out["umap_epoch_err"] = float(np.abs(on_card[0] - on_cpu).max())
    on_card.append(one_epoch(device, with_ulp_noise(calc.cv.embedding_)))
    out["umap_epoch_card_spread"] = float(max(np.abs(e - on_card[0]).max() for e in on_card))
    out["umap_epoch_moved"] = float(np.abs(on_cpu - calc.cv.embedding_).max())

    # the whole fit on a cut: card against CPU with the same draws, beside
    # the card's spread between inputs one float32 ulp apart
    cut = calc.cv.training_data[:UMAP_CUT]
    fits = {}
    for name, dev, data in (("card", device, cut), ("cpu", "cpu", cut),
                            ("noisy", device, with_ulp_noise(cut))):
        model_cut = UMAPModel(2, device=dev)
        fits[name], out[f"umap_cut_{name}_s"] = synced(
            lambda: model_cut.fit(data, numpy_draws(UMAP_CUT)).embedding_, dev)
    out["umap_cut_err"] = float(np.abs(align_signs(fits["card"], fits["cpu"]) - fits["cpu"]).max())
    out["umap_cut_ulp_noise_spread"] = float(
        np.abs(align_signs(fits["noisy"], fits["card"]) - fits["card"]).max())
    fit_s = out["umap_fit_s"]
    log(f"[{card}] UMAP at {n} x {len(kept)}: run() {out['umap_run_s']:.2f} s (kNN "
        f"{fit_s['knn']:.3f}, sigma {fit_s['sigma']:.3f}, symmetrize "
        f"{fit_s['symmetrize']:.3f}, PCA init {fit_s['pca_init']:.3f}, layout "
        f"{fit_s['layout']:.3f} s for 300 epochs over {out['umap_edges']} edges), transform "
        f"of {n} frames {out['umap_transform_s']:.3f} s, save {out['umap_save_s']:.2f} s "
        f"({out['umap_zip_mb']:.0f} MB zip), load {out['umap_load_s']:.2f} s, "
        f"project_colvars ({COLVARS_FRAMES} frames) {out['umap_project_colvars_s']:.2f} s; "
        f"from_model_zip refused")
    log(f"[{card}] UMAP checks: kNN of {UMAP_KNN_SAMPLE} rows, {exact} exactly numpy's, the "
        f"rest within {out['umap_knn_max_excess_ulps']:.2f} ulps "
        f"({out['umap_knn_max_excess_of_bound']:.3g} of the float32 bound; on the first "
        f"{UMAP_KNN_CUT} rows {out[f'umap_knn_{UMAP_KNN_CUT}_exact_rows']} exact, "
        f"{out[f'umap_knn_{UMAP_KNN_CUT}_max_excess_ulps']:.2f} ulps, "
        f"{out[f'umap_knn_{UMAP_KNN_CUT}_max_excess_of_bound']:.3g} of the bound); sigma within rel "
        f"{out['umap_sigma_max_rel_err']:.3g}; one layout epoch (points moved up to "
        f"{out['umap_epoch_moved']:.3g}) card vs CPU {out['umap_epoch_err']:.3g}, card vs "
        f"card over {LAYOUT_REPEATS} runs and one with one-ulp noise "
        f"{out['umap_epoch_card_spread']:.3g}; "
        f"fit on {UMAP_CUT} rows card vs CPU {out['umap_cut_err']:.3g}, one-ulp spread "
        f"{out['umap_cut_ulp_noise_spread']:.3g} (card {out['umap_cut_card_s']:.2f} s, CPU "
        f"{out['umap_cut_cpu_s']:.2f} s)")
    tol = max(LAYOUT_TOL, ULP_SPREAD_MULTIPLE * out["umap_epoch_card_spread"])
    check(out["umap_epoch_err"] <= tol,
          f"one layout epoch on the card within {tol:.3g} of the CPU")
    tol = conditioning_tol(out["umap_cut_ulp_noise_spread"])
    check(out["umap_cut_err"] <= tol,
          f"UMAP fit on {UMAP_CUT} rows, card against CPU, within {tol:.3g}")
    return out


def phase8(ctx: dict, tmp: str, stats, card: str, device="cuda") -> dict:
    """Phase 8: geometry analysis and UMAP, the kernels' counts zeroed
    before and read after."""
    for st in stats:
        st.launches = 0
    t0 = time.perf_counter()
    out = geometry(ctx, tmp, card, device)
    out.update(hydrogen_bonds(tmp, card, device))
    out.update(muller_brown(card, device))
    out.update(umap_cv(ctx, tmp, card, device))
    out["launches"] = {st.name: st.launches for st in stats}
    out["phase8_s"] = time.perf_counter() - t0
    if device == "cuda":
        check(out["launches"]["pair_distances_kernel"] >= 2,
              "K1 featurized dRMSD's reference and trajectory")
        out.update(first_svd_in_a_process(ctx["frames"].shape[0]))
        log(f"[{card}] the first batched SVD of a process ({ctx['frames'].shape[0]} x 3 x 3) "
            f"{out['first_svd_s']:.3f} s, a second {out['second_svd_s']:.4f} s")
    log(json.dumps(out))
    return out


def elapsed_seconds(text: str) -> int:
    """Seconds of a "HH h MM min SS s" duration."""
    h, _, m, _, sec, _ = text.split()
    return int(h) * 3600 + int(m) * 60 + int(sec)


def pipeline_inputs(coords: np.ndarray, root: str) -> dict:
    """The training DCD, the seed DCD and the supplementary DCD, each with
    its CA PDB, as a user would pass them."""
    from deep_cartograph_torch.io.dcd import write_dcd

    os.makedirs(root, exist_ok=True)
    cuts = {"train": coords[slice(*PIPELINE_TRAIN)],
            "seed": coords[slice(*PIPELINE_SEED)],
            "sup": coords[slice(*PIPELINE_SUP)]}
    paths = {}
    for name, frames in cuts.items():
        paths[name] = (os.path.join(root, f"{name}.dcd"), os.path.join(root, f"{name}.pdb"))
        write_dcd(paths[name][0], frames)
        write_ca_pdb(paths[name][1], frames[0])
    return paths


def run_command_line(argv: list, records: list):
    """cli.main() in this process with `argv` as its command line; the log
    records of the package are kept in `records` by a handler added once
    the command line has set up its logging."""
    import logging

    from deep_cartograph_torch import cli

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep()
    set_logger = cli.set_logger

    def set_logger_and_keep(*args, **kwargs):
        set_logger(*args, **kwargs)
        logging.getLogger("deep_cartograph_torch").addHandler(keep)

    saved_argv, cli.set_logger, sys.argv = sys.argv, set_logger_and_keep, argv
    try:
        cli.main()
    finally:
        sys.argv, cli.set_logger = saved_argv, set_logger
        logger = logging.getLogger("deep_cartograph_torch")
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()
        logger.propagate = True


def split_rows(values: np.ndarray, labels: np.ndarray, n: int):
    return [values[labels == i] for i in range(n)]


def read_table(path: str):
    """A CSV of the tools: (header, float64 matrix), True/False as 1/0."""
    import csv

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    cells = [[1.0 if c == "True" else 0.0 if c == "False" else float(c) for c in r]
             for r in rows[1:]]
    return rows[0], np.array(cells, np.float64).reshape(len(cells), len(rows[0]))


def check_nearest_clusters(sup: np.ndarray, sup_cluster: np.ndarray,
                           ref: np.ndarray, ref_cluster: np.ndarray) -> int:
    """Each sampled supplementary row's cluster is that of a reference row
    at the float64 nearest distance, within NN_ULPS float32 ulps of the
    expansion's terms (rounded CSV values tie often). Returns the rows
    whose float64 nearest row lies in another cluster (a tie)."""
    rows = np.linspace(0, len(sup) - 1, min(PIPELINE_NN_SAMPLE, len(sup))).astype(int)
    a = sup[rows].astype(np.float64)
    b = ref.astype(np.float64)
    a2, b2 = (a ** 2).sum(1)[:, None], (b ** 2).sum(1)[None, :]
    d2 = a2 - 2 * a @ b.T + b2
    scale = a2 + b2.max()
    tol = NN_ULPS * np.spacing(scale.astype(np.float32)).astype(np.float64)
    near = d2 <= d2.min(1, keepdims=True) + tol
    ties = 0
    for i, r in enumerate(rows):
        allowed = set(ref_cluster[near[i]].tolist())
        check(int(sup_cluster[r]) in allowed,
              f"supplementary row {r} in the cluster of a nearest clustered row")
        ties += int(ref_cluster[d2[i].argmin()] != sup_cluster[r])
    return ties


def pipeline(coords: np.ndarray, tmp: str, stats, card: str, device="cuda") -> dict:
    """Phase 9: deep_cartograph() through its command line, on the card,
    the kernels' counts zeroed before and read after, then its files held
    to numpy and to the saved models."""
    import importlib.util

    import torch

    from deep_cartograph_torch.cv.base import CVCalculator
    from deep_cartograph_torch.io.colvars import read_colvars
    from deep_cartograph_torch.stats.descriptors import quantile_mask, standard_deviation

    root = os.path.join(tmp, "pipeline")
    paths = pipeline_inputs(coords, os.path.join(root, "inputs"))
    conf = os.path.join(root, "config.json")
    with open(conf, "w") as fh:
        json.dump(PIPELINE_CONFIG, fh)
    out_dir = os.path.join(root, "out")
    argv = ["deep_carto_torch", "-conf", conf,
            "-traj_data", paths["train"][0], "-top_data", paths["train"][1],
            "-seed_traj_data", paths["seed"][0], "-seed_top_data", paths["seed"][1],
            "-sup_traj_data", paths["sup"][0], "-sup_top_data", paths["sup"][1],
            "-out", out_dir]
    records: list = []
    out = {"matplotlib_importable": importlib.util.find_spec("matplotlib") is not None,
           "yaml_importable": importlib.util.find_spec("yaml") is not None}
    loaded_before = {m for m in ("matplotlib", "pandas", "yaml") if m in sys.modules}
    for st in stats:
        st.launches = 0
    t0 = time.perf_counter()
    run_command_line(argv, records)
    if device == "cuda":
        torch.cuda.synchronize()
    out["deep_cartograph_s"] = time.perf_counter() - t0
    out["launches"] = {st.name: st.launches for st in stats}
    out["step_s"] = {}
    for message in records:
        if message.startswith("Elapsed time ("):
            step, _, duration = message[len("Elapsed time ("):].partition("): ")
            out["step_s"].setdefault(step, []).append(elapsed_seconds(duration))
    if device == "cuda":
        check(out["launches"]["pair_distances_kernel"] > 0, "K1 ran in the pipeline")
    # With every figure flag off, only analyze_geometry's plots (the schema
    # has no flag for them) may load matplotlib, and only where it exists.
    loaded = sorted({m for m in ("matplotlib", "pandas", "yaml")
                     if m in sys.modules} - loaded_before)
    out["libraries_loaded"] = loaded
    allowed = ["matplotlib"] if out["matplotlib_importable"] else []
    check(set(loaded) <= set(allowed),
          f"the pipeline loaded no pandas or yaml, nor matplotlib where it is "
          f"missing ({loaded})")

    # The colvars: every 50th training row against float64 numpy.
    cf = os.path.join(out_dir, "compute_features")
    train_colvars = os.path.join(cf, "train", "colvars.dat")
    seed_colvars = os.path.join(cf, "seed_augmented_pchip", "colvars.dat")
    sup_colvars = os.path.join(out_dir, "compute_ref_features", "sup", "colvars.dat")
    out["colvars_bytes"] = sum(os.path.getsize(p) for p in
                               (train_colvars, seed_colvars, sup_colvars))
    data, names = read_colvars(train_colvars)
    labels = names[1:]
    check(sorted(labels) == sorted(make_labels(N_ATOMS)), "the 1,171 features of the path")
    n_train = PIPELINE_TRAIN[1] - PIPELINE_TRAIN[0]
    check(data.shape == (n_train, 1172), f"training colvars shape {data.shape}")
    rows = slice(0, n_train, PIPELINE_CHECK_STRIDE)
    ref = numpy_features(coords[slice(*PIPELINE_TRAIN)][rows], labels)
    out["colvars_err_vs_numpy"] = float(np.abs(data[rows, 1:] - ref).max())
    check(out["colvars_err_vs_numpy"] <= PIPELINE_FEATURES_TOL,
          f"colvars within {PIPELINE_FEATURES_TOL} of float64 numpy")
    seed_data, _ = read_colvars(seed_colvars)
    sup_data, _ = read_colvars(sup_colvars)
    check(seed_data.shape == (1000, 1172), f"augmented seed colvars {seed_data.shape}")
    check(sup_data.shape == (PIPELINE_SUP[1] - PIPELINE_SUP[0], 1172),
          f"supplementary colvars {sup_data.shape}")

    # The filter: phase 3's std-median screen on the same rows.
    with open(os.path.join(out_dir, "filter_features", "filtered_features.txt")) as fh:
        kept = [line.strip() for line in fh if line.strip()]
    rows_all = np.concatenate([data[:, 1:], seed_data[:, 1:]])
    keep = quantile_mask(standard_deviation(rows_all, device), STD_QUANTILE)
    check(kept == [lab for lab, k in zip(labels, keep) if k],
          "the filter kept phase 3's std-median screen")
    out["n_kept"] = len(kept)

    # Each CV: its CSVs against its model.zip's projection of the colvars.
    tc = os.path.join(out_dir, "train_colvars")
    trajectories = ["train", "seed"]
    tops = [paths["train"][1], os.path.join(out_dir, "traj_augmentation",
                                            "seed_augmented_pchip.pdb")]
    out["csv_err_vs_model"] = {}
    out["clusters"] = {}
    out["nn_ties"] = {}
    for cv in PIPELINE_CVS:
        model = CVCalculator.load(os.path.join(tc, cv, "model.zip"),
                                  os.path.join(root, "served", cv), device)
        if cv == "umap":
            train_want = [(model.cv.embedding_ - model.cv_norm_mean) / model.cv_norm_range]
            train_want = split_rows(train_want[0], np.repeat(
                [0, 1], [n_train, 1000]), 2)
        else:
            values, _ = model.project_colvars([train_colvars, seed_colvars], tops)
            train_want = split_rows(values, model.projection_data_labels, 2)
        sup_want, _ = model.project_colvars([sup_colvars], [paths["sup"][1]])
        err = 0.0
        cv_rows = []
        for name, want in zip(trajectories, train_want):
            header, got = read_table(os.path.join(tc, cv, "traj_data", name,
                                                  "projected_trajectory.csv"))
            check(header == model.cv_labels and got.shape == want.shape,
                  f"{cv} {name} CSV header and shape")
            err = max(err, float(np.abs(got - want).max()))
        header, got = read_table(os.path.join(out_dir, "traj_projection", cv, "sup",
                                              "projected_trajectory.csv"))
        check(got.shape == sup_want.shape, f"{cv} supplementary CSV shape")
        err = max(err, float(np.abs(got - sup_want).max()))
        out["csv_err_vs_model"][cv] = err
        check(err <= PIPELINE_CSV_TOL, f"{cv} CSVs within {PIPELINE_CSV_TOL} of model.zip")

        # The clusters: JAX column order, one centroid per cluster, k in [3, 10].
        clustered = []
        for name in ("train", "seed_augmented_pchip"):
            header, table = read_table(os.path.join(out_dir, "traj_cluster", cv, name,
                                                    "projected_trajectory.csv"))
            check(header == [*model.cv_labels, "traj_label", "cluster", "centroid",
                             "frame"], f"{cv} cluster CSV columns {header}")
            clustered.append(table)
        table = np.concatenate(clustered)
        k = len(np.unique(table[:, 3]))
        out["clusters"][cv] = k
        check(3 <= k <= 10, f"{cv}: {k} clusters in [3, 10]")
        check(int(table[:, 4].sum()) == k, f"{cv}: one centroid per cluster")
        header, sup_table = read_table(os.path.join(out_dir, "traj_cluster", cv,
                                                    "sup_sup", "projected_trajectory.csv"))
        check(header == [*model.cv_labels, "traj_label", "cluster"],
              f"{cv} supplementary cluster CSV columns {header}")
        out["nn_ties"][cv] = check_nearest_clusters(
            sup_table[:, :2], sup_table[:, 3], table[:, :2], table[:, 3])
        del model
    log(f"[{card}] pipeline (deep_carto_torch, JSON configuration): "
        f"deep_cartograph {out['deep_cartograph_s']:.1f} s; steps "
        + ", ".join(f"{k} {'+'.join(str(v) for v in vs)} s"
                    for k, vs in out["step_s"].items())
        + f"; colvars {out['colvars_bytes'] / 1e6:.1f} MB; {out['n_kept']} features "
        f"kept; K1 launches {out['launches']['pair_distances_kernel']}; "
        f"matplotlib importable {out['matplotlib_importable']}, PyYAML importable "
        f"{out['yaml_importable']}")
    log(json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 10: native host I/O and transport
# ---------------------------------------------------------------------------

def dihedral_error_bound(coords: np.ndarray, quads: np.ndarray,
                         delta: np.ndarray) -> np.ndarray:
    """(frames, quads): how far the sine or cosine of a dihedral can move
    when each coordinate moves by at most delta (per frame, per axis), and
    the float32 rounding of two evaluations. With F = r0 - r1, G = r1 - r2,
    H = r3 - r2 (each moving by at most d = 2 sqrt(3) delta), A = F x G and
    B = H x G, the sine and cosine are products of the unit vectors of A, B
    and G; a unit vector moves by at most 2 |dV| / |V| (and by 2 at most),
    and |dA| <= d |G| + |F| d + d^2. Float32 loses eps |F||G| / |A| of A."""
    x = coords.astype(np.float64)
    f = x[:, quads[:, 0]] - x[:, quads[:, 1]]
    g = x[:, quads[:, 1]] - x[:, quads[:, 2]]
    h = x[:, quads[:, 3]] - x[:, quads[:, 2]]
    nf, ng, nh = (np.linalg.norm(v, axis=-1) for v in (f, g, h))
    na = np.linalg.norm(np.cross(f, g), axis=-1)
    nb = np.linalg.norm(np.cross(h, g), axis=-1)
    d = 2 * np.sqrt(3) * delta[:, None]
    moved = (np.minimum(2, 2 * (d * ng + nf * d + d * d) / na)
             + np.minimum(2, 2 * (d * ng + nh * d + d * d) / nb)
             + np.minimum(2, 2 * d / ng))
    eps = float(np.finfo(np.float32).eps)
    return moved + INT16_FLOAT32_ALLOWANCE + 16 * eps * (nf * ng / na + nh * ng / nb)


def int16_excess(got: np.ndarray, exact: np.ndarray, coords: np.ndarray, labels,
                 chunk: int) -> dict:
    """How far the int16 features pass their derived bound (<= 0 holds), by
    feature family, and the largest errors and bounds. A chunk's coordinate
    moves by at most its quantization_step per axis, plus the float32
    rounding of the dequantized value."""
    from deep_cartograph_torch.io.upload import quantization_step, quantize_coords

    delta = np.empty(coords.shape[0])
    eps = float(np.finfo(np.float32).eps)
    for s in range(0, coords.shape[0], chunk):
        block = coords[s:s + chunk]
        delta[s:s + chunk] = (quantization_step(quantize_coords(block)[1])
                              + 2 * eps * float(np.abs(block).max()))
    dist = [i for i, lab in enumerate(labels) if lab.startswith("dist-")]
    out = {"delta_max": float(delta.max())}
    # a distance (nm) moves by at most 0.1 x 2 sqrt(3) delta
    bound = 0.1 * 2 * np.sqrt(3) * delta[:, None] + INT16_FLOAT32_ALLOWANCE
    err = np.abs(got[:, dist] - exact[:, dist])
    out.update(dist_err=float(err.max()), dist_bound=float(bound.max()),
               dist_excess=float((err - bound).max()))
    for kind in ("sin", "cos"):
        cols = [i for i, lab in enumerate(labels) if lab.startswith(kind + "-")]
        quads = np.array([[int(e.rsplit("_", 1)[1]) - 1 for e in labels[i].split("-")[1:]]
                          for i in cols])
        bound = dihedral_error_bound(coords, quads, delta)
        err = np.abs(got[:, cols] - exact[:, cols])
        # a bound of 1 or more cannot fail (two sines or cosines differ by at
        # most 2 and are both rounded): those entries are counted, not held
        held = bound < 1
        out.update({f"{kind}_unbounded": int((~held).sum()),
                    f"{kind}_err_unbounded": float(err[~held].max(initial=0.0)),
                    f"{kind}_err": float(err[held].max()),
                    f"{kind}_bound_at_max_err": float(
                        bound[held][np.argmax(err[held])]),
                    f"{kind}_excess": float((err - bound)[held].max())})
    return out


def htica_fits(ctx: dict, coords: np.ndarray, stats, card: str, device="cuda") -> dict:
    """fit, fit_fused and fit_chunked of the streaming HTICA at phase 4's
    shape (the first 20,000 frames, the first 580 kept features, 10
    subspaces x 5, lag 10), on blocks featurized through K1 from
    coordinates on the card and normalized there. fit_fused and fit_chunked
    run under torch.profiler: each kernel's launches in the trace, less
    those its wrapper counted, are the CUDA graphs' replays (their times
    include the profiler's cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_cartograph_torch.cv.htica_stream import StreamingHTICA
    from deep_cartograph_torch.geom.kernels import PlanEvaluator
    from deep_cartograph_torch.features.grammar import compile_plan
    from deep_cartograph_torch.io.topology import Topology

    labels = make_labels(N_ATOMS)
    names = ctx["kept"][:HTICA_STREAM_FEATURES]
    evaluator = PlanEvaluator(compile_plan(labels, Topology.from_pdb(ctx["pdb_path"])),
                              device=device)
    index = {lab: i for i, lab in enumerate(labels)}
    frames = torch.as_tensor(coords[:COLVARS_FRAMES], device=device)
    cols = torch.as_tensor([index[n] for n in names], device=device)
    whole = evaluator.eval_raw(frames).index_select(1, cols)
    mean, std = whole.mean(0), whole.std(0)
    normalized = ((whole - mean) / std).double().cpu().numpy()
    del whole

    def block_fn(start, frames, cols, mean, std):
        rows = start + torch.arange(HTICA_BLOCK, device=frames.device)
        block = evaluator.eval_raw(frames.index_select(0, rows)).index_select(1, cols)
        return (block - mean) / std

    args = (frames, cols, mean, std)

    def estimator():
        return StreamingHTICA(len(names), LINEAR_CONFIG["num_subspaces"],
                              LINEAR_CONFIG["subspaces_dimension"], 2,
                              LINEAR_CONFIG["lag_time"], device=device)

    def fit(est):
        est.fit(lambda: (block_fn(torch.tensor(s, device=device), *args)
                         for s in range(0, COLVARS_FRAMES, HTICA_BLOCK)))

    out: dict = {}
    runs = {}
    # fit_fused and fit_chunked each replay every block of their two passes
    expected = {"pair_distances_kernel": 2 * 2 * (COLVARS_FRAMES // HTICA_BLOCK),
                "kde_logsumexp_kernel": 0, "pairwise_distance_matrix_kernel": 0}
    replays = dict.fromkeys(TRACE_NAMES, 0)
    for method, call in (
        ("fit", fit),
        ("fit_fused", lambda est: est.fit_fused(lambda start: block_fn(start, *args),
                                                COLVARS_FRAMES, HTICA_BLOCK)),
        ("fit_chunked", lambda est: est.fit_chunked(
            block_fn, COLVARS_FRAMES, HTICA_BLOCK,
            blocks_per_dispatch=HTICA_BLOCKS_PER_DISPATCH, block_args=args)),
    ):
        est = estimator()
        if method == "fit":
            _, out[f"htica_{method}_s"] = synced(lambda: call(est), device)
        else:
            counted = {st.name: st.launches for st in stats}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, out[f"htica_{method}_s"] = synced(lambda: call(est), device)
            on_card = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            for st in stats:
                traced = sum(TRACE_NAMES[st.name] in n for n in on_card)
                replays[st.name] += traced - (st.launches - counted[st.name])
        runs[method] = (est, normalized @ est.weights)
    out["graph_replay_launches"] = replays
    out["graph_replay_launches_expected"] = expected
    check(0 < replays["pair_distances_kernel"] <= expected["pair_distances_kernel"]
          and replays["kde_logsumexp_kernel"] == replays["pairwise_distance_matrix_kernel"] == 0,
          f"the traces show K1 launched by graph replays, at most once a block of "
          f"each pass ({replays}, expected {expected})")
    ref, ref_proj = runs["fit"]
    check(bool(np.isfinite(ref_proj).all()), "streaming HTICA projection finite")
    out["htica_eigenvalues"] = np.asarray(ref.eigenvalues_).tolist()
    for method in ("fit_fused", "fit_chunked"):
        est, proj = runs[method]
        out[f"htica_{method}_eigenvalue_err"] = float(
            np.abs(np.asarray(est.eigenvalues_) - ref.eigenvalues_).max())
        out[f"htica_{method}_projection_err"] = float(np.abs(proj - ref_proj).max())
        check(max(out[f"htica_{method}_eigenvalue_err"],
                  out[f"htica_{method}_projection_err"]) <= FUSED_TOL,
              f"{method} within {FUSED_TOL} of fit "
              f"({out[f'htica_{method}_eigenvalue_err']}, "
              f"{out[f'htica_{method}_projection_err']})")
    log(f"[{card}] streaming HTICA on blocks featurized through K1 ({COLVARS_FRAMES} x "
        f"{len(names)}, blocks of {HTICA_BLOCK}): fit {out['htica_fit_s']:.2f} s, "
        f"fit_fused {out['htica_fit_fused_s']:.2f} s, fit_chunked "
        f"({HTICA_BLOCKS_PER_DISPATCH} blocks a graph) {out['htica_fit_chunked_s']:.2f} s; "
        f"against fit: fused {out['htica_fit_fused_projection_err']:.3g}, chunked "
        f"{out['htica_fit_chunked_projection_err']:.3g}; K1 launched by graph replays "
        f"{replays['pair_distances_kernel']} times in the traces (expected "
        f"{expected['pair_distances_kernel']})")
    return out


def demo_and_plumed(tmp: str, card: str, device="cuda") -> dict:
    """One demo dataset materialized, one of its systems featurized (DCD
    prefetch, K1) against the CPU and float64 numpy; the PLUMED driver run
    on an exported input where PLUMED is installed."""
    import glob
    import zipfile

    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.dcd import read_dcd
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.plumed.cli import (
        get_driver_command,
        plumed_available,
        run_plumed,
    )
    from deep_cartograph_torch.utils.demo_data import CALPHA_SYSTEMS, materialize

    out: dict = {}
    root = os.path.join(tmp, "demo")
    _, out["demo_materialize_s"] = synced(lambda: materialize(root, [DEMO_DATASET]),
                                          device)
    folder = os.path.join(root, DEMO_DATASET, "input", DEMO_SYSTEM)
    dcd, pdb = (os.path.join(folder, f"{DEMO_SYSTEM}.{ext}") for ext in ("dcd", "pdb"))
    n_res = CALPHA_SYSTEMS[DEMO_SYSTEM][2]
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, n_res + 1)
              for j in range(i + 1, n_res + 1)]
    top = Topology.from_pdb(pdb)
    feats, out["demo_featurize_s"] = synced(
        lambda: Featurizer(top, labels, device=device).featurize_trajectory(dcd), device)
    cpu = Featurizer(top, labels, device="cpu").featurize_trajectory(dcd)
    out["demo_err_vs_cpu"] = float(np.abs(feats - cpu).max())
    out["demo_err_vs_numpy"] = float(np.abs(feats - numpy_features(read_dcd(dcd),
                                                                    labels)).max())
    check(feats.shape == (200, len(labels))
          and max(out["demo_err_vs_cpu"], out["demo_err_vs_numpy"]) <= 1e-5,
          f"demo features match the CPU and numpy ({out['demo_err_vs_cpu']}, "
          f"{out['demo_err_vs_numpy']})")

    out["plumed_available"] = plumed_available()
    if out["plumed_available"]:
        calc = cv_calculators_map["pca"]({"dimension": 2, "features_normalization":
                                          "mean_std", "training": {"plot_loss": False}},
                                         os.path.join(tmp, "demo_cv"), device=device)
        calc._set_training_data(feats, None, labels)
        calc.ref_topology_path = pdb
        calc.run()
        export = os.path.join(tmp, "demo_plumed")
        os.makedirs(export)
        calc.write_plumed_files(pdb, export)
        for archive in glob.glob(os.path.join(export, "*.zip")):
            with zipfile.ZipFile(archive) as zf:
                zf.extractall(export)
        plumed_input = sorted(glob.glob(os.path.join(export, "plumed_input_*.dat")))[0]
        (stdout, stderr), out["plumed_driver_s"] = synced(lambda: run_plumed(
            get_driver_command(plumed_input, dcd, top.n_atoms), working_dir=export),
            device)
        check(stdout is not None, f"the PLUMED driver ran {plumed_input}")
        log(f"[{card}] plumed driver on {os.path.basename(plumed_input)}: "
            f"{out['plumed_driver_s']:.2f} s")
    else:
        log(f"[{card}] plumed driver not run: no plumed binary on this machine")
    log(f"[{card}] demo {DEMO_DATASET} materialized in {out['demo_materialize_s']:.2f} s; "
        f"{DEMO_SYSTEM} ({len(labels)} distances x 200 frames) featurized in "
        f"{out['demo_featurize_s'] * 1e3:.1f} ms (against the CPU "
        f"{out['demo_err_vs_cpu']:.3g})")
    return out


def native_io(ctx: dict, coords: np.ndarray, tmp: str, stats, card: str,
              device="cuda") -> dict:
    """Phase 10: the native host I/O and transport (the kernels' counts
    zeroed before and read after): the main path's DCD featurized again with
    int16 upload and held to the float32 features within the derived bound;
    phase 4's colvars file written and read natively with the memory cache
    on; the batch dip test over the kept features; the streaming HTICA's
    fit, fit_fused and fit_chunked on blocks featurized through K1; one demo
    dataset; the PLUMED driver."""
    import torch

    from deep_cartograph_torch.geom.engine import Featurizer, auto_chunk_size
    from deep_cartograph_torch.io import colvars
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.stats.descriptors import (
        dip_pvalues,
        dip_pvalues_plain,
        dip_statistics_batch,
    )
    from deep_cartograph_torch.stats.dip import dip_statistic

    labels = make_labels(N_ATOMS)
    out: dict = {}
    for st in stats:
        st.launches = 0

    # 1. int16 transport on the main path's DCD (prefetch reader, K1).
    featurizer = Featurizer(Topology.from_pdb(ctx["pdb_path"]), labels, device=device)
    int16, out["featurize_int16_s"] = synced(lambda: featurizer.featurize_trajectory(
        ctx["dcd_path"], frame_chunk=CHUNK, upload="int16"), device)
    _, out["featurize_float32_s"] = synced(lambda: featurizer.featurize_trajectory(
        ctx["dcd_path"], frame_chunk=CHUNK, upload="float32"), device)
    chunk = auto_chunk_size(CHUNK, N_ATOMS, len(labels))
    out.update({f"int16_{k}": v for k, v in int16_excess(
        int16, ctx["features"], coords, labels, chunk).items()})
    log(f"[{card}] featurize with int16 upload {out['featurize_int16_s']:.3f} s "
        f"(float32 again {out['featurize_float32_s']:.3f} s); coordinates moved by at "
        f"most {out['int16_delta_max']:.3g} A; against float32: distances "
        f"{out['int16_dist_err']:.3g} nm (bound {out['int16_dist_bound']:.3g}), sin "
        f"{out['int16_sin_err']:.3g} (its bound {out['int16_sin_bound_at_max_err']:.3g}), "
        f"cos {out['int16_cos_err']:.3g} (its bound "
        f"{out['int16_cos_bound_at_max_err']:.3g}); not held, a bound of 1 or more: "
        f"{out['int16_sin_unbounded']} sin (err up to {out['int16_sin_err_unbounded']:.3g}), "
        f"{out['int16_cos_unbounded']} cos (err up to {out['int16_cos_err_unbounded']:.3g})")
    check(int16.shape == ctx["features"].shape and all(
        out[f"int16_{k}_excess"] <= 0 for k in ("dist", "sin", "cos")),
        "int16 features within the quantization bound of the float32 features")
    del int16

    # 2. Phase 4's colvars file, natively, with the memory cache on.
    saved = os.environ.pop("DEEP_CARTO_COLVARS_CACHE_BYTES", None)
    try:
        path = os.path.join(tmp, "colvars_native.dat")
        rows = ctx["features"][:COLVARS_FRAMES]
        data = np.column_stack([np.arange(COLVARS_FRAMES, dtype=np.float32), rows])
        names = ["time"] + labels
        colvars.clear_memory_cache()
        _, out["colvars_write_s"] = synced(lambda: colvars.write_colvars(
            path, data, names, fmt=COLVARS_FMT), device)
        out["colvars_mb"] = os.path.getsize(path) / 1e6
        (cached, _), out["colvars_cached_read_s"] = synced(
            lambda: colvars.read_features_matrix(path), device)
        colvars.clear_memory_cache()
        (cold, cold_names), out["colvars_read_s"] = synced(
            lambda: colvars.read_features_matrix(path), device)
        check(cold_names == labels and np.array_equal(cold.view(np.uint32),
                                                      cached.view(np.uint32)),
              "the cold read of the native file equals the cached read bit for bit")
        out["colvars_max_abs_err"] = float(np.abs(cold - rows).max())
        check(out["colvars_max_abs_err"] <= COLVARS_TOL,
              f"colvars values within {COLVARS_TOL}")
        plain = os.path.join(tmp, "colvars_plain.dat")
        _, out["colvars_plain_write_s"] = synced(lambda: colvars.write_colvars_plain(
            plain, data[:COLVARS_PLAIN_ROWS], names, fmt=COLVARS_FMT), device)
        with open(plain, "rb") as fh:
            plain_bytes = fh.read()
        with open(path, "rb") as fh:
            native_head = fh.read(len(plain_bytes))
        check(native_head == plain_bytes, f"the first {COLVARS_PLAIN_ROWS} rows of the "
              "native file equal the Python writer's bytes")
        body = plain_bytes[plain_bytes.index(b"\n") + 1:]
        _, out["colvars_plain_read_s"] = synced(
            lambda: colvars.parse_body_plain(body, len(names)), device)
        plain_mb = len(plain_bytes) / 1e6
        out["colvars_write_mb_s"] = out["colvars_mb"] / out["colvars_write_s"]
        out["colvars_read_mb_s"] = out["colvars_mb"] / out["colvars_read_s"]
        out["colvars_plain_write_mb_s"] = plain_mb / out["colvars_plain_write_s"]
        out["colvars_plain_read_mb_s"] = plain_mb / out["colvars_plain_read_s"]
        del cached, cold
    finally:
        colvars.clear_memory_cache()
        if saved is not None:
            os.environ["DEEP_CARTO_COLVARS_CACHE_BYTES"] = saved
    log(f"[{card}] native colvars {COLVARS_FRAMES} x {data.shape[1]} "
        f"({out['colvars_mb']:.1f} MB): write {out['colvars_write_s']:.2f} s "
        f"({out['colvars_write_mb_s']:.1f} MB/s), cold read {out['colvars_read_s']:.2f} s "
        f"({out['colvars_read_mb_s']:.1f} MB/s), cached read "
        f"{out['colvars_cached_read_s'] * 1e3:.1f} ms; plain on {COLVARS_PLAIN_ROWS} rows: "
        f"write {out['colvars_plain_write_mb_s']:.1f} MB/s, loadtxt "
        f"{out['colvars_plain_read_mb_s']:.1f} MB/s")

    # 3. The batch dip test over the kept features; 16 held to the Python dip.
    kept = ctx["kept_features"].cpu().numpy()
    pvalues, out["dip_batch_s"] = synced(lambda: dip_pvalues(kept), device)
    some = kept[:, :DIP_PLAIN_FEATURES]
    plain_p, out["dip_plain_s"] = synced(lambda: dip_pvalues_plain(some), device)
    dips = dip_statistics_batch(some)
    out["dip_features"] = kept.shape[1]
    out["dip_stat_err"] = float(max(abs(d - dip_statistic(some[:, j]))
                                    for j, d in enumerate(dips)))
    out["dip_pvalue_err"] = float(np.abs(pvalues[:DIP_PLAIN_FEATURES] - plain_p).max())
    check(pvalues.shape == (kept.shape[1],) and bool(np.isfinite(pvalues).all())
          and max(out["dip_stat_err"], out["dip_pvalue_err"]) <= DIP_TOL,
          f"the dip batch matches the Python dip ({out['dip_stat_err']}, "
          f"{out['dip_pvalue_err']})")
    log(f"[{card}] dip test: batch over {kept.shape[1]} features x {kept.shape[0]} "
        f"frames {out['dip_batch_s']:.2f} s; the Python dip on {DIP_PLAIN_FEATURES} "
        f"{out['dip_plain_s']:.2f} s (p-values within {out['dip_pvalue_err']:.3g})")
    del kept

    # 4. The streaming HTICA on generated blocks; 5. demo data and PLUMED.
    out.update(htica_fits(ctx, coords, stats, card, device))
    out.update(demo_and_plumed(tmp, card, device))
    out["launches"] = {st.name: st.launches for st in stats}
    if device == "cuda":
        check(out["launches"]["pair_distances_kernel"] > 0, "K1 ran in phase 10")
        torch.cuda.empty_cache()
    log(json.dumps(out))
    return out


def smoke_mesh(divides: int = 0, device="cuda"):
    """Phase 11's mesh: every visible card, else cuda:0 listed four times.
    With `divides`, a mesh whose size divides it: the most cards that do,
    else cuda:0 listed 5 times (the 10 subspaces and 10 tries)."""
    import torch

    from deep_cartograph_torch.parallel.mesh import Mesh

    n = torch.cuda.device_count() if device == "cuda" else 1
    if n > 1:
        k = max(k for k in range(1, n + 1) if not divides or divides % k == 0)
        return Mesh([f"cuda:{i}" for i in range(k)])
    first = "cuda:0" if device == "cuda" else "cpu"
    return Mesh([first] * (5 if divides else 4))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def align_columns(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a's columns flipped to correlate positively with b's."""
    return a * np.sign(np.sum(a * b, axis=0))


def multi_gpu(calc, ctx: dict, coords: np.ndarray, tmp: str, stats, card: str,
              device="cuda") -> dict:
    """Phase 11: every sharded path at the main path's width, on the mesh of
    every visible card (else cuda:0 listed four times), each step warmed,
    then timed on one device (a mesh of cuda:0 alone), on the mesh and by
    its default route, each held to the one-device run and to phase 3 (the
    kernels' counts zeroed before and read after):
    the Featurizer's auto-shard on the DCD and its int16 upload (K1 a
    shard), FramesToCV, entropy and std, TICA, the streaming HTICA, the
    try-sharded deep-TICA, the 2-D FES (K2 a shard), and one data-parallel
    step over an NCCL group of one process (gloo for a rehearsal on the
    CPU, `device="cpu"`)."""
    import torch
    import torch.distributed as dist

    from deep_cartograph_torch.cv.htica_stream import StreamingHTICA
    from deep_cartograph_torch.cv.tica_math import tica
    from deep_cartograph_torch.deploy import FramesToCV
    from deep_cartograph_torch.features.grammar import compile_plan
    from deep_cartograph_torch.fes.kde import compute_fes
    from deep_cartograph_torch.geom.engine import Featurizer, auto_chunk_size
    from deep_cartograph_torch.geom.kernels import PlanEvaluator
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.models.training import Optimizer
    from deep_cartograph_torch.parallel import Mesh, init_distributed, mesh_for, use_mesh
    from deep_cartograph_torch.parallel.training import make_dp_train_step
    from deep_cartograph_torch.stats.descriptors import shannon_entropy, standard_deviation

    t_phase = time.perf_counter()
    one = Mesh(["cuda:0" if device == "cuda" else "cpu"])
    mesh, mesh10 = smoke_mesh(device=device), smoke_mesh(10, device)
    first_device = one.devices[0]

    def default_devices(divides=0):
        """The devices a call on the first device runs over with no mesh
        set: `mesh_for`'s, or the device alone where the mesh does not
        divide `divides` (the 10 subspaces and tries)."""
        n = len(mesh_for(first_device))
        return 1 if divides and divides % n else n

    k1, k2 = stats[0], stats[1]
    labels = make_labels(N_ATOMS)
    top = Topology.from_pdb(ctx["pdb_path"])
    out: dict = {"mesh": [str(d) for d in mesh], "mesh_of_10": [str(d) for d in mesh10],
                 "cards": torch.cuda.device_count()}
    for st in stats:
        st.launches = st.plain_calls = 0

    def count(st):
        """A kernel's launches (on the CPU: calls of its plain version)."""
        return st.launches if device == "cuda" else st.plain_calls

    def routes(name, fn, on=None, divides=0):
        """fn() warm, once on one device and once on the mesh (the first
        call of each may pay a card's first use), then timed once each
        way: on one device (a mesh of cuda:0 alone), on the mesh
        (`use_mesh`), and by the default route (no `use_mesh`): the
        (one-device, mesh, default-route) results. Records the default
        route's device count (`mesh_for(device)`, the device alone where
        it does not divide `divides`)."""
        on = on or mesh
        with use_mesh(one):
            _, out[f"{name}_one_first_s"] = synced(fn, device)
        with use_mesh(on):
            _, out[f"{name}_sharded_first_s"] = synced(fn, device)
        with use_mesh(one):
            single, out[f"{name}_one_s"] = synced(fn, device)
        with use_mesh(on):
            sharded, out[f"{name}_sharded_s"] = synced(fn, device)
        default, out[f"{name}_default_s"] = synced(fn, device)
        out[f"{name}_sharded_devices"] = len(on)
        out[f"{name}_default_devices"] = default_devices(divides)
        return single, sharded, default

    # 1. The Featurizer's auto-shard on the DCD, float32 and int16 uploads.
    featurizer = Featurizer(top, labels, device=device)
    chunks = -(-N_FRAMES // auto_chunk_size(CHUNK, N_ATOMS, len(labels)))
    with use_mesh(mesh):
        check(featurizer.evaluator.mesh is mesh, "the Featurizer shards over the mesh")
    for upload in ("float32", "int16"):
        before = count(k1)
        single, sharded, default = routes(
            f"featurize_{upload}", lambda: featurizer.featurize_trajectory(
                ctx["dcd_path"], frame_chunk=CHUNK, upload=upload))
        out[f"featurize_{upload}_k1_launches"] = count(k1) - before
        check(out[f"featurize_{upload}_k1_launches"]
              == chunks * (2 + 2 * len(mesh) + out[f"featurize_{upload}_default_devices"]),
              f"K1 once a chunk on one device and once a shard of each chunk, by each "
              f"route ({upload})")
        for route, got in (("", sharded), ("_default", default)):
            out[f"featurize_{upload}{route}_err_vs_one"] = float(np.abs(got - single).max())
            out[f"featurize_{upload}{route}_bit_equal"] = bool(np.array_equal(got, single))
            check(out[f"featurize_{upload}{route}_err_vs_one"] <= 1e-6,
                  f"{route[1:] or 'sharded'} {upload} features equal the one-device ones "
                  f"({out[f'featurize_{upload}{route}_err_vs_one']})")
        if upload == "float32":
            out["featurize_err_vs_phase3"] = float(np.abs(sharded - ctx["features"]).max())
            check(out["featurize_err_vs_phase3"] <= 1e-6,
                  f"sharded features equal phase 3's ({out['featurize_err_vs_phase3']})")
        else:
            excess = int16_excess(sharded, ctx["features"], coords, labels,
                                  auto_chunk_size(CHUNK, N_ATOMS, len(labels)))
            out.update({f"int16_{k}": v for k, v in excess.items()})
            check(all(excess[f"{k}_excess"] <= 0 for k in ("dist", "sin", "cos")),
                  "sharded int16 features within phase 10's bound")
        del single, sharded, default

    # 2. Serving: FramesToCV over the 100,000 frames, K1 once a chunk of the
    # staged copy up of each device's slice (`PlanEvaluator.chunk_frames`).
    step = FramesToCV(calc.projection(), top, ctx["kept"], device=device) \
        .evaluator.evaluators[0].chunk_frames(ctx["frames"].shape[1])

    def staged_chunks(n_devices):
        """K1 launches of one call over `n_devices` devices' slices."""
        return sum(-(-len(part) // step) for part in np.array_split(ctx["frames"], n_devices))

    before = count(k1)
    single, sharded, default = routes("frames_to_cv", lambda: FramesToCV(
        calc.projection(), top, ctx["kept"], device=device)(ctx["frames"]))
    out["frames_to_cv_k1_launches"] = count(k1) - before
    out["frames_to_cv_chunk_frames"] = step
    out["frames_to_cv_err_vs_phase3"] = float(np.abs(sharded - ctx["cv"]).max())
    out["frames_to_cv_err_vs_one"] = float(np.abs(sharded - single).max())
    out["frames_to_cv_default_err_vs_one"] = float(np.abs(default - single).max())
    check(out["frames_to_cv_k1_launches"]
          == 2 * staged_chunks(1) + 2 * staged_chunks(len(mesh))
          + staged_chunks(out["frames_to_cv_default_devices"])
          and max(out["frames_to_cv_err_vs_phase3"], out["frames_to_cv_err_vs_one"],
                  out["frames_to_cv_default_err_vs_one"]) <= 1e-5,
          f"sharded and default-route FramesToCV within 1e-5 of phase 3 and one device "
          f"({out['frames_to_cv_err_vs_phase3']}, {out['frames_to_cv_err_vs_one']}, "
          f"{out['frames_to_cv_default_err_vs_one']})")

    # 3. Entropy and std, feature-sharded, of the host feature matrix.
    (ent1, std1), (ent, std), (ent_d, std_d) = routes("entropy_std", lambda: (
        shannon_entropy(ctx["features"], device=device),
        standard_deviation(ctx["features"], device=device)))
    out["entropy_std_equal"] = bool(all(
        np.array_equal(a, b) for a, b in ((ent, ent1), (std, std1), (ent_d, ent1),
                                          (std_d, std1), (ent, ctx["entropy"]),
                                          (std, ctx["std"]))))
    check(out["entropy_std_equal"],
          "feature-sharded and default-route entropy and std equal phase 3's")

    # 4. TICA through the calculator, its covariances frame-sharded at
    # 100,000 x 586. C0's condition number is near 2e7, so the weights are
    # ill-determined in float32: the projection is held to the one-device
    # one within its one-ulp spread (`conditioning_tol`), as in phase 4.
    def tica_calc(data=None):
        t = linear_calculator("tica", os.path.join(tmp, "multi_gpu_tica"), device)
        t._set_training_data(ctx["kept_features"] if data is None else data,
                             np.zeros(N_FRAMES, np.int64), ctx["kept"])
        t.compute_cv()
        return t

    def tica_projection(t):
        t.normalize_cv()
        return t.project_data(t.training_data, normalize_data=False)

    tica_one, tica_mesh, tica_default = routes("tica", tica_calc)
    with use_mesh(one):
        noisy = tica_calc(with_ulp_noise(ctx["kept_features"]))
    jitter, ref = tica_projection(noisy), tica_projection(tica_one)
    for route, got in (("", tica_mesh), ("_default", tica_default)):
        out[f"tica{route}_eigenvalue_err"] = float(np.abs(np.asarray(got.eigenvalues_)
                                                          - tica_one.eigenvalues_).max())
        out[f"tica{route}_weights_err"] = float(
            np.abs(align_columns(got.cv, tica_one.cv) - tica_one.cv).max()
            / np.abs(tica_one.cv).max())
        out[f"tica{route}_projection_err"] = float(
            np.abs(align_columns(tica_projection(got), ref) - ref).max())
    out["tica_ulp_noise_spread"] = float(np.abs(align_columns(jitter, ref) - ref).max())
    out["tica_weights_ulp_noise_spread"] = float(np.abs(
        align_columns(noisy.cv, tica_one.cv) - tica_one.cv).max() / np.abs(tica_one.cv).max())
    x = ctx["kept_features"]
    _, out["tica_sharded_fn_s"] = synced(
        lambda: tica(x[:-10], x[10:], 2, device=device, mesh=mesh), device)
    tol = conditioning_tol(out["tica_ulp_noise_spread"])
    for route in ("", "_default"):
        check(out[f"tica{route}_eigenvalue_err"] <= EIGVAL_TOL
              and out[f"tica{route}_projection_err"] <= tol,
              f"{route[1:] or 'sharded'} TICA eigenvalues within {EIGVAL_TOL} "
              f"({out[f'tica{route}_eigenvalue_err']}), projection within {tol:.3g} of one "
              f"device ({out[f'tica{route}_projection_err']}; weights "
              f"{out[f'tica{route}_weights_err']:.3g} of the largest, one-ulp input noise "
              f"{out['tica_weights_ulp_noise_spread']:.3g})")
    del tica_one, tica_mesh, tica_default, noisy, jitter, ref

    # 5. The streaming HTICA at phase 4's shape, the subspaces over the mesh.
    names = ctx["kept"][:HTICA_STREAM_FEATURES]
    index = {lab: i for i, lab in enumerate(labels)}
    evaluator = PlanEvaluator(compile_plan(labels, top), device=device)
    frames = torch.as_tensor(coords[:COLVARS_FRAMES], device=device)
    cols = torch.as_tensor([index[n] for n in names], device=device)
    whole = evaluator.eval_raw(frames).index_select(1, cols)
    normalized = (whole - whole.mean(0)) / whole.std(0)
    del whole, frames

    def htica():
        # the calculator's routing (cv/linear.py): the mesh where it
        # divides the subspaces, else the device alone
        est_mesh = mesh_for(first_device)
        if LINEAR_CONFIG["num_subspaces"] % len(est_mesh):
            est_mesh = Mesh((first_device,))
        est = StreamingHTICA(len(names), LINEAR_CONFIG["num_subspaces"],
                             LINEAR_CONFIG["subspaces_dimension"], 2,
                             LINEAR_CONFIG["lag_time"], device=device, mesh=est_mesh)
        est.fit(lambda: (normalized[s:s + HTICA_BLOCK]
                         for s in range(0, COLVARS_FRAMES, HTICA_BLOCK)))
        return est

    est_one, est_mesh, est_default = routes("htica", htica, mesh10,
                                            LINEAR_CONFIG["num_subspaces"])
    host = normalized.double().cpu().numpy()
    ref = host @ est_one.weights
    for route, got in (("", est_mesh), ("_default", est_default)):
        out[f"htica{route}_eigenvalue_err"] = float(
            np.abs(got.eigenvalues_ - est_one.eigenvalues_).max())
        out[f"htica{route}_projection_err"] = float(
            np.abs(align_columns(host @ got.weights, ref) - ref).max())
        check(max(out[f"htica{route}_eigenvalue_err"],
                  out[f"htica{route}_projection_err"]) <= FUSED_TOL,
              f"streaming HTICA, {route[1:] or 'over the mesh'}, within {FUSED_TOL} of one "
              f"device ({out[f'htica{route}_eigenvalue_err']}, "
              f"{out[f'htica{route}_projection_err']})")
    del normalized, host

    # 6. Deep-TICA with the 10 tries over the mesh, 2 epochs.
    def train():
        c = calculator("deep_tica", TRAIN_CONFIG, calc.training_data,
                       calc.features_ref_labels, device, max_epochs=BREAKDOWN_EPOCHS)
        c.train()
        return c

    train_one, train_mesh, train_default = routes(
        "train", train, mesh10, TRAIN_CONFIG["training"]["general"]["num_tries"])
    for route, got in (("", train_mesh), ("_default", train_default)):
        out[f"train{route}_loss_max_rel_diff"] = max(
            float(np.max(np.abs(np.asarray(a.metrics[k]) - b.metrics[k])
                         / np.maximum(np.abs(b.metrics[k]), 1e-12)))
            for (_, a), (_, b) in zip(got.try_results, train_one.try_results)
            for k in ("train_loss", "valid_loss"))
        check(out[f"train{route}_loss_max_rel_diff"] <= CARD_CPU_LOSS_RTOL,
              f"{route[1:] or 'try-sharded'} per-epoch losses within rel "
              f"{CARD_CPU_LOSS_RTOL} of one device ({out[f'train{route}_loss_max_rel_diff']})")
    del train_one, train_mesh, train_default

    # 7. The 2-D FES with each block's samples over the mesh (K2 a shard).
    before = count(k2)
    (_, fes1, _), (_, fes, _), (_, fes_d, _) = routes("fes_2d", lambda: compute_fes(
        ctx["cv"], bandwidth=BANDWIDTH, num_bins=NUM_BINS, num_blocks=1, device=device))
    out["fes_2d_k2_launches"] = count(k2) - before
    out["fes_2d_err_vs_phase3"] = float(np.abs(fes - ctx["fes_2d"]).max())
    out["fes_2d_err_vs_one"] = float(np.abs(fes - fes1).max())
    out["fes_2d_default_err_vs_one"] = float(np.abs(fes_d - fes1).max())
    check(out["fes_2d_k2_launches"] == 2 + 2 * len(mesh) + out["fes_2d_default_devices"]
          and max(out["fes_2d_err_vs_phase3"], out["fes_2d_err_vs_one"],
                  out["fes_2d_default_err_vs_one"]) <= FES_TOL,
          f"sharded and default-route 2-D FES within {FES_TOL} kJ/mol of phase 3 and one "
          f"device ({out['fes_2d_err_vs_phase3']}, {out['fes_2d_err_vs_one']}, "
          f"{out['fes_2d_default_err_vs_one']})")

    # 8. One data-parallel step over an NCCL group (one process) on the mesh.
    port = free_port()
    init_distributed(f"localhost:{port}", 1, 0, device=device)
    check(not dist.is_initialized(), "init_distributed does nothing for one process")
    t0 = time.perf_counter()
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    out["nccl_init_s"] = time.perf_counter() - t0
    try:
        rows = min(8192, len(ctx["kept_features"]))
        batch = {"data": ctx["kept_features"][:rows],
                 "target": torch.as_tensor(ctx["cv"][:rows], device=device),
                 "weight": torch.ones(rows, device=device)}
        w0 = torch.as_tensor(np.random.default_rng(SEED).normal(
            0, 0.05, (len(ctx["kept"]), 2)).astype(np.float32), device=device)

        def loss(params, b):
            err = ((b["data"] @ params["w"] - b["target"]) ** 2).mean(1)
            return (err * b["weight"]).sum() / b["weight"].sum().clamp_min(1e-9)

        optimizer = Optimizer("Adam", {"lr": 1e-3})
        params = {"w": w0.clone()}
        state = optimizer.init(params)
        step = make_dp_train_step(loss, optimizer, Mesh(mesh.devices, group=dist.group.WORLD),
                                  1e-3)
        (_, _, dp_loss), out["dp_step_s"] = synced(lambda: step(params, state, batch),
                                                   device)
        w1 = params["w"].clone()
        # a second step on a copy, timed once the communicator exists
        _, out["dp_step_again_s"] = synced(
            lambda: step({"w": w1.clone()}, optimizer.init(params), batch), device)
        plain = {"w": w0.clone().requires_grad_(True)}
        plain_loss = loss(plain, batch)
        (grad,) = torch.autograd.grad(plain_loss, [plain["w"]])
        plain_state = optimizer.init(plain)
        optimizer.step(plain, {"w": grad}, plain_state,
                       torch.tensor([1e-3], device=device))
        out["dp_step_err"] = float((params["w"] - plain["w"].detach()).abs().max())
        out["dp_loss_rel_err"] = abs(float(dp_loss) / float(plain_loss) - 1)
        # Adam's first update is about lr * sign(g); SGD's (lr 1) is the
        # summed gradient itself, held to the full batch's
        sgd = Optimizer("SGD", {"lr": 1.0})
        sgd_params = {"w": w0.clone()}
        make_dp_train_step(loss, sgd, Mesh(mesh.devices, group=dist.group.WORLD), 1.0)(
            sgd_params, sgd.init(sgd_params), batch)
        out["dp_sgd_gradient_rel_err"] = float(
            ((w0 - sgd_params["w"]) - grad).abs().max() / grad.abs().max())
    finally:
        dist.destroy_process_group()
    check(out["dp_step_err"] <= 1e-5 and out["dp_loss_rel_err"] <= 1e-5
          and out["dp_sgd_gradient_rel_err"] <= DP_GRADIENT_RTOL,
          f"the data-parallel step equals a plain step ({out['dp_step_err']}, "
          f"{out['dp_loss_rel_err']}; SGD against the full batch's gradient "
          f"{out['dp_sgd_gradient_rel_err']})")

    out["launches"] = {st.name: count(st) for st in stats}
    out["phase11_s"] = time.perf_counter() - t_phase
    check(out["launches"]["pair_distances_kernel"] > 0
          and out["launches"]["kde_logsumexp_kernel"] > 0, "K1 and K2 ran in phase 11")
    steps = [k[:-len("_sharded_s")] for k in out if k.endswith("_sharded_s")]
    for k in steps:
        one_s = out[f"{k}_one_s"]
        out[f"{k}_sharded_ratio"] = out[f"{k}_sharded_s"] / one_s
        out[f"{k}_default_ratio"] = out[f"{k}_default_s"] / one_s
        n_default = out[f"{k}_default_devices"]
        route = ("one device" if n_default == 1 else f"{n_default} devices") + (
            ", the one-device run (one card)" if out["cards"] == 1 else "")
        log(f"[{card}] multi_gpu {k}: one device {one_s:.4f} s (first "
            f"{out[f'{k}_one_first_s']:.4f} s); mesh of {out[f'{k}_sharded_devices']} "
            f"{out[f'{k}_sharded_s']:.4f} s = {out[f'{k}_sharded_ratio']:.3f} x one device "
            f"(first {out[f'{k}_sharded_first_s']:.4f} s); default route ({route}) "
            f"{out[f'{k}_default_s']:.4f} s = {out[f'{k}_default_ratio']:.3f} x one device")
    log(f"[{card}] multi_gpu on {out['mesh']} ({out['cards']} card(s); 10 subspaces and "
        f"tries on {len(mesh10)}): NCCL init {out['nccl_init_s']:.2f} s, dp step "
        f"{out['dp_step_s'] * 1e3:.1f} ms (again {out['dp_step_again_s'] * 1e3:.1f} ms); "
        f"phase {out['phase11_s']:.1f} s")
    log(f"[{card}] multi_gpu held: features {'bit-equal' if out['featurize_float32_bit_equal'] else out['featurize_float32_err_vs_one']}, "
        f"int16 {out['featurize_int16_err_vs_one']:.3g}, FramesToCV "
        f"{out['frames_to_cv_err_vs_phase3']:.3g}, TICA eigenvalues "
        f"{out['tica_eigenvalue_err']:.3g}, projection {out['tica_projection_err']:.3g} "
        f"(one-ulp spread {out['tica_ulp_noise_spread']:.3g}), HTICA "
        f"{out['htica_projection_err']:.3g}, training rel {out['train_loss_max_rel_diff']:.3g}, "
        f"FES {out['fes_2d_err_vs_phase3']:.3g} kJ/mol, dp step {out['dp_step_err']:.3g}, "
        f"SGD gradient rel {out['dp_sgd_gradient_rel_err']:.3g}; "
        f"launches {out['launches']}")
    log(json.dumps(out))
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def multi_gpu_only(coords: np.ndarray, card: str, start: float) -> int:
    """`--multi-gpu`: phase 3 on cuda:0 alone (phase 11's references), then
    phase 11 on every visible card; no kernels line."""
    import torch

    from deep_cartograph_torch.ops import kde as k2
    from deep_cartograph_torch.ops import pair_distances as k1
    from deep_cartograph_torch.ops import pairwise_distance_matrix as k3
    from deep_cartograph_torch.parallel import Mesh, use_mesh

    stats = [k1.STATS, k2.STATS, k3.STATS]
    with tempfile.TemporaryDirectory() as tmp:
        with use_mesh(Mesh(["cuda:0"])):
            _, calc, ctx = main_path(coords, tmp, stats)
        multi_gpu(calc, ctx, coords, tmp, stats, card)
        del ctx
    log(f"[{card}] total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def main() -> int:
    import torch

    start = time.perf_counter()
    if sys.argv[1:] not in ([], ["--multi-gpu"]):
        print("usage: chip_smoke.py [--multi-gpu]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from deep_cartograph_torch.ops import build
    from deep_cartograph_torch.ops import kde as k2
    from deep_cartograph_torch.ops import pair_distances as k1
    from deep_cartograph_torch.ops import pairwise_distance_matrix as k3
    from deep_cartograph_torch.features.grammar import compile_plan
    from deep_cartograph_torch.io.topology import Topology

    # Phase 1: device and build.
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_rate = SFU_OPS_PER_CLOCK_PER_SM * num_sms * sm_clock_hz
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{num_sms} SMs at {sm_clock_hz / 1e6:.0f} MHz max")
    t0 = time.perf_counter()
    build.build_all()
    log(f"built {len(build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s")
    # The host C++ (XTC codec, colvars text, DCD prefetch, dip batch), built
    # here so that no step below times a first-use compile.
    from deep_cartograph_torch.io import colvars, dcd, xtc
    from deep_cartograph_torch.stats import descriptors

    host_sources = [xtc._CODEC_SOURCE, colvars._SOURCE, dcd._SOURCE,
                    descriptors._DIP_SOURCE]
    t0 = time.perf_counter()
    build.build_host_all(host_sources)
    log(f"built {len(host_sources)} host libraries in {time.perf_counter() - t0:.1f} s")

    coords = make_trajectory(N_FRAMES, N_ATOMS)
    if sys.argv[1:] == ["--multi-gpu"]:
        return multi_gpu_only(coords, card, start)
    with tempfile.TemporaryDirectory() as tmp:
        pdb_path = os.path.join(tmp, "ca.pdb")
        write_ca_pdb(pdb_path, coords[0])
        plan = compile_plan(make_labels(N_ATOMS), Topology.from_pdb(pdb_path))
    pairs = plan.dist_pairs.astype(np.int32)

    # Phase 2: kernels against their plain versions.
    records = check_kernels(coords, pairs, sfu_rate)
    for name, rec in records.items():
        log(f"[{card}] {name} {rec['name']}: err {rec['max_abs_err']:.3g}, "
            f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
            f"library {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"by {rec['bound_by']})")

    # Phase 3: the main path; phase 4: the CV file surface on its data.
    stats = [k1.STATS, k2.STATS, k3.STATS]
    with tempfile.TemporaryDirectory() as tmp:
        result, calc, ctx = main_path(coords, tmp, stats)
        surface, linear = cv_surface(calc, ctx, tmp, stats, card)
        phase6 = autoencoders(calc, linear, ctx, tmp, stats, card)
        del linear
        inputs_and_clustering = phase7(calc, coords, ctx, tmp, stats, card)
        geometry_and_umap = phase8(ctx, tmp, stats, card)
        pipeline_run = pipeline(coords, tmp, stats, card)
        native = native_io(ctx, coords, tmp, stats, card)
        multi = multi_gpu(calc, ctx, coords, tmp, stats, card)
        del ctx
    log(f"[{card}] featurize {N_FRAMES / result['featurize_s']:.0f} frames/s "
        f"({result['featurize_s']:.3f} s, host decode alone "
        f"{result['decode_s']:.3f} s, by read_dcd slices {result['decode_slices_s']:.3f} s), "
        f"upload {result['upload_s']:.3f} s, "
        f"stats (entropy + std) {result['stats_s']:.3f} s, filter "
        f"{result['filter_s'] * 1e3:.1f} ms (again {result['filter_again_s'] * 1e3:.1f} ms) "
        f"({result['n_kept']} of 1171 kept), data to the calculator "
        f"{result['set_data_s']:.3f} s")
    scores = ", ".join(f"{t['score']:.5f}" for t in result["tries"])
    log(f"[{card}] train {result['train_s']:.3f} s for "
        f"{len(result['tries'])} tries x {calc.max_epochs} epochs at most, "
        f"post-normalization {result['normalize_cv_s']:.3f} s; "
        f"scores {scores}; selected {result['selected_score']:.5f}")
    log(f"[{card}] projection {result['project_s'] * 1e3:.1f} ms, FES 1-D x2 "
        f"{result['fes_1d_s'] * 1e3:.1f} ms, FES 2-D {result['fes_2d_s'] * 1e3:.1f} ms "
        f"(again: {', '.join(f'{t * 1e3:.2f}' for t in result['fes_2d_again_s'])} ms)")
    log(json.dumps(result))

    # Phase 5: the card against the CPU; one training step in detail.
    compare = card_against_cpu("deep_tica", TRAIN_CONFIG, calc, CUT_FRAMES)
    compare.update(training_breakdown("deep_tica", TRAIN_CONFIG, calc))
    log(f"[{card}] cut-down training ({CUT_FRAMES} frames, {CUT_TRIES} tries, "
        f"{CUT_EPOCHS} epochs): card {compare['card_s']:.3f} s, CPU "
        f"{compare['cpu_s']:.3f} s, losses within rel "
        f"{compare['loss_max_rel_diff']:.3g}, projection within "
        f"{compare['projection_max_abs_diff']:.3g}")
    log(f"[{card}] training, {compare['epochs']} epochs of {compare['steps_per_epoch']} "
        f"steps ({calc.num_tries} tries x {calc.batch_size} pairs): host syncs "
        f"{compare['host_syncs_train']} in all; under torch.profiler "
        f"{compare['profiled_sync_calls_per_step']:.2f} sync calls per step, a "
        f"step {compare['profiled_step_ms']:.3f} ms of host time launching "
        f"{compare['profiled_step_device_ms']:.3f} ms of card work "
        f"(card busy {compare['profiled_step_busy_share']:.1%} of the steps' card "
        f"windows), card busy "
        f"{compare['profiled_train_busy_share']:.1%} of the profiled training "
        f"({compare['profiled_train_s']:.3f} s)")
    log(json.dumps(compare))

    kernels = []
    for key in ("K1", "K2", "K3"):
        rec = dict(records[key])
        by_path = {"main_path": result["launches"][rec["name"]],
                   "cv_surface": surface["launches"][rec["name"]],
                   "autoencoders": phase6["launches"][rec["name"]],
                   "inputs_and_clustering": inputs_and_clustering["launches"][rec["name"]],
                   "geometry": geometry_and_umap["launches"][rec["name"]],
                   "pipeline": pipeline_run["launches"][rec["name"]],
                   "native_io": native["launches"][rec["name"]],
                   "multi_gpu": multi["launches"][rec["name"]]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        rec["graph_replay_launches"] = native["graph_replay_launches"][rec["name"]]
        rec["kernel_ms"] = rec["ms"]
        kernels.append(rec)
    log(f"[{card}] total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
