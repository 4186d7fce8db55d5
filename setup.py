from setuptools import find_packages, setup

setup(
    name="deep_cartograph_tpu",
    version="0.1.0",
    description=(
        "TPU-native framework for mapping MD trajectories onto learned "
        "collective variables (JAX/XLA/Pallas)"
    ),
    packages=find_packages(include=["deep_cartograph_tpu*", "deep_cartograph*"]),
    package_data={
        "deep_cartograph_tpu": ["log_config/*.ini", "native/*.cpp",
                                "default_config.yml"],
        "deep_cartograph_torch": ["ops/csrc/*.cu", "ops/csrc/*.cuh", "io/csrc/*.cpp",
                                  "stats/csrc/*.cpp", "geom/csrc/*.cpp",
                                  "stats/dip_null_table.npz", "log_config/*.ini",
                                  "default_config.yml"],
    },
    python_requires=">=3.10",
    entry_points={
        "console_scripts": [
            # drop-in names matching the reference's console scripts
            "deep_carto = deep_cartograph_tpu.cli:main",
            "deep_carto_tpu = deep_cartograph_tpu.cli:main",
            "align_trajectories = deep_cartograph_tpu.tool_cli:align_trajectories_main",
            "analyze_geometry = deep_cartograph_tpu.tool_cli:analyze_geometry_main",
            "compute_features = deep_cartograph_tpu.tool_cli:compute_features_main",
            "filter_features = deep_cartograph_tpu.tool_cli:filter_features_main",
            "train_colvars = deep_cartograph_tpu.tool_cli:train_colvars_main",
            "traj_augmentation = deep_cartograph_tpu.tool_cli:traj_augmentation_main",
            "traj_cluster = deep_cartograph_tpu.tool_cli:traj_cluster_main",
            "traj_projection = deep_cartograph_tpu.tool_cli:traj_projection_main",
            # the PyTorch/CUDA port's pipeline; its tools run as
            # `python -m deep_cartograph_torch.tool_cli <tool> ...`
            "deep_carto_torch = deep_cartograph_torch.cli:main",
        ]
    },
)
