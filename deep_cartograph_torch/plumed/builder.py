"""PLUMED input builders: assemble + PRINT + write to disk.

Parity with deep_cartograph/modules/plumed/input/builder.py:18-115 (the
JAX package's module, with the port's assemblers).
"""

from __future__ import annotations

from deep_cartograph_torch.plumed.assembler import (
    Assembler,
    CollectiveVariableAssembler,
    EnhancedSamplingAssembler,
)


class ComputeFeaturesBuilder(Assembler):
    """Input file tracking a collection of features along a trajectory/MD run."""

    def build(self, colvars_path: str) -> None:  # type: ignore[override]
        super().build()
        self.print_args = list(self.features_list)
        self.add_print_command(colvars_path, self.traj_stride)
        self.write()


class ComputeCVBuilder(CollectiveVariableAssembler):
    """Input file tracking a trained CV along a trajectory/MD run."""

    def build(self, colvars_path: str) -> None:  # type: ignore[override]
        super().build()
        if not self.cv_labels:
            raise ValueError("No CV labels defined.")
        self.print_args.extend(self.cv_labels)
        self.add_print_command(colvars_path, self.traj_stride)
        self.write()


class ComputeEnhancedSamplingBuilder(EnhancedSamplingAssembler):
    """Input file biasing an MD run along a trained CV."""

    def build(self, colvars_path: str) -> None:  # type: ignore[override]
        super().build()
        if not self.cv_labels:
            raise ValueError("No CV labels defined.")
        self.print_args.extend(self.cv_labels)
        self.print_args.extend(self.bias_labels)
        self.add_print_command(colvars_path, self.traj_stride)
        self.write()
