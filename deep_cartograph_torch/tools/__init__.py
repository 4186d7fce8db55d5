from deep_cartograph_torch.tools.align_trajectories import align_trajectories
from deep_cartograph_torch.tools.analyze_geometry import analyze_geometry
from deep_cartograph_torch.tools.compute_features import compute_features
from deep_cartograph_torch.tools.filter_features import filter_features
from deep_cartograph_torch.tools.train_colvars import TrainColvarsWorkflow, train_colvars
from deep_cartograph_torch.tools.traj_augmentation import traj_augmentation
from deep_cartograph_torch.tools.traj_cluster import TrajClusterWorkflow, traj_cluster
from deep_cartograph_torch.tools.traj_projection import (
    TrajProjectionWorkflow,
    traj_projection,
)
