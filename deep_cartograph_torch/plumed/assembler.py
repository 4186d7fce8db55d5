"""PLUMED input-file assembly.

Composes complete PLUMED inputs (features section, CV section, enhanced-
sampling section) with the same structure and semantics as the reference
assemblers (deep_cartograph/modules/plumed/input/assembler.py:20-616):
linear CVs become normalized COMBINE chains; non-linear CVs become a
PYTORCH_MODEL action pointing at the exported TorchScript weights. This is
the deployment contract that lets trained CVs drive enhanced-sampling MD
in PLUMED-enabled engines. The JAX package's module, with the port's
topology and feature grammar. Differences, on purpose: the first line of an
input names the port; a linear CV loaded from a model.zip keeps its feature
normalization (`add_linear_cv`; the JAX package drops it there).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Literal, Optional

import numpy as np

from deep_cartograph_torch.features.grammar import to_mda_selection
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.plumed import command as cmd

logger = logging.getLogger(__name__)

# The first line of every input.
HEADER = "# PLUMED input file generated with Deep Cartograph (PyTorch port)\n"


class Assembler:
    """Base assembler: header, MOLINFO, WHOLEMOLECULES, optional
    FIT_TO_TEMPLATE, feature commands."""

    def __init__(
        self,
        plumed_input_path: str,
        topology_path: str,
        features_list: List[str],
        traj_stride: int,
        fit_template_path: Optional[str] = None,
    ):
        self.input_content: str = ""
        self.plumed_input_path = plumed_input_path
        self.topology_path = topology_path
        self.fit_template_path = fit_template_path
        self.features_list = features_list
        self.traj_stride = traj_stride
        self.print_args: List[str] = []

        self.fit_to_template_needed = any(
            f.startswith("coord") for f in features_list
        )
        if self.fit_to_template_needed and self.fit_template_path is None:
            raise ValueError(
                "Features contain coordinates but no fit template path was provided."
            )
        self._topology = Topology.from_file(topology_path)

    # ------------------------------------------------------------------
    def build(self) -> None:
        self.input_content += HEADER
        # Referenced files are emitted as BASENAMES: every file the input
        # needs (topology, fit template, weights) ships next to it in the
        # exported zip, so the unzipped folder is portable to the machine
        # that runs the MD engine. (The reference assembler.py:90 writes
        # os.path.abspath, which breaks its own gromacs_biased_simulations
        # example off the build host — its shipped .dat is hand-fixed to
        # relative paths; this emits them relative from the start.)
        self.input_content += cmd.molinfo(os.path.basename(self.topology_path))
        whole_indices = self._topology.indices_one_based()
        self.input_content += cmd.wholemolecules(whole_indices)
        if self.fit_to_template_needed:
            self.input_content += cmd.fit_to_template(
                os.path.basename(self.fit_template_path)
            )
        self.input_content += "\n# Features\n"
        self.add_center_commands()
        for feature in self.features_list:
            self.input_content += self.get_feature_command(feature)

    # ------------------------------------------------------------------
    def get_feature_command(self, feature_label: str) -> str:
        """Feature label -> PLUMED action text (grammar parity with
        assembler.py:115-233; '@NAME_RES' entities become '@NAME-RES')."""
        entities = feature_label.split("-")
        feat_name = entities[0]

        if feat_name == "dist":
            if len(entities) != 3:
                raise ValueError(f"Malformed distance feature label: {feature_label}")
            atoms = [
                e if e.startswith("center_") else e.replace("_", "-")
                for e in entities[1:]
            ]
            return cmd.distance(feature_label, atoms)

        if feat_name == "coord":
            if len(entities) != 2 or "." not in entities[1]:
                raise ValueError(f"Malformed coord feature label: {feature_label}")
            atom, axis = entities[1].split(".")
            # POSITION yields .x/.y/.z components; emit it once per atom —
            # with the FIRST axis of that atom present in the feature list
            # (feature filtering can drop .x while keeping .y/.z; keying on
            # .x alone would leave the kept components undefined).
            axes_present = [
                ax for ax in ("x", "y", "z")
                if f"coord-{atom}.{ax}" in self.features_list
            ]
            first = axes_present[0] if axes_present else "x"
            if axis == first:
                return cmd.position(f"coord-{atom}", atom.replace("_", "-"))
            return ""

        if feat_name in ("sin", "cos"):
            if len(entities) not in (2, 5):
                raise ValueError(f"Malformed {feat_name} feature label: {feature_label}")
            torsion_label = feature_label.replace(feat_name, "tor", 1)
            text = ""
            # The torsion action is shared by the sin/cos pair: emit with the
            # sin feature, or with cos when no sin twin exists.
            twin = feature_label.replace(feat_name, "sin", 1)
            if feat_name == "sin" or twin not in self.features_list:
                text += cmd.torsion(
                    torsion_label, [e.replace("_", "-") for e in entities[1:]]
                )
            text += cmd.custom(
                feature_label,
                expression=f"{feat_name}(x)",
                arguments=[torsion_label],
                periodic=False,
            )
            return text

        if feat_name == "tor":
            if len(entities) not in (2, 5):
                raise ValueError(f"Malformed tor feature label: {feature_label}")
            return cmd.torsion(
                feature_label, [e.replace("_", "-") for e in entities[1:]]
            )

        raise ValueError(f"Feature {feature_label} not recognized.")

    def add_center_commands(self) -> None:
        written: List[str] = []
        for feature in self.features_list:
            for entity in feature.split("-"):
                if entity.startswith("center_") and entity not in written:
                    selection = to_mda_selection(entity.replace("center_", ""))
                    indices = self._topology.indices_one_based(selection)
                    self.input_content += cmd.center(entity, indices)
                    written.append(entity)

    def add_print_command(self, colvars_path: str, stride: int) -> None:
        self.input_content += "\n"
        self.input_content += cmd.print_(self.print_args, colvars_path, stride)

    def write(self) -> None:
        with open(self.plumed_input_path, "w") as fh:
            fh.write(self.input_content)


class CollectiveVariableAssembler(Assembler):
    """Adds a CV section: linear COMBINE chains or PYTORCH_MODEL
    (cf. reference assembler.py:280-447)."""

    def __init__(
        self,
        plumed_input_path: str,
        topology_path: str,
        features_list: List[str],
        traj_stride: int,
        cv_type: str,
        cv_params: Dict,
        fit_template_path: Optional[str] = None,
    ):
        super().__init__(
            plumed_input_path, topology_path, features_list, traj_stride,
            fit_template_path,
        )
        self.cv_type: Literal["linear", "non-linear"] = cv_type
        self.cv_params = cv_params
        self.cv_labels: List[str] = []

    def build(self) -> None:
        super().build()
        self.add_cv_section()

    def add_cv_section(self) -> None:
        if self.cv_type == "linear":
            self.add_linear_cv()
        elif self.cv_type == "non-linear":
            self.add_non_linear_cv()
        else:
            raise ValueError(f"CV type {self.cv_type} not recognized.")

    def add_linear_cv(self) -> None:
        """Normalized features -> COMBINE per component -> normalized CV
        (cf. assembler.py:333-379)."""
        p = self.cv_params
        required = (
            "features_norm_mode", "features_norm_mean", "features_norm_range",
            "weights", "cv_dimension", "cv_stats",
        )
        for key in required:
            if key not in p:
                raise ValueError(f"Linear CV requires {key}.")
        p.setdefault("cv_name", "cv")
        weights = np.asarray(p["weights"])
        if weights.shape[0] != len(self.features_list):
            raise ValueError(
                f"CV weights shape {weights.shape} does not match the number "
                f"of features {len(self.features_list)}"
            )
        if p["cv_dimension"] != weights.shape[1]:
            raise ValueError(
                f"CV dimension {p['cv_dimension']} does not match weight "
                f"columns {weights.shape[1]}"
            )

        mode = p["features_norm_mode"]
        mean = np.asarray(p["features_norm_mean"])
        rng = np.asarray(p["features_norm_range"])
        # A model loaded from a zip has lost its mode's name (metadata.json
        # does not keep it) but not its arrays, which the projection applies:
        # write them unless they are the identity of mode None.
        if mode is not None or np.any(mean != 0) or np.any(rng != 1):
            self.input_content += "\n# Normalized features\n"
            normalized_labels = []
            for i, feature in enumerate(self.features_list):
                label = f"feat_{i}"
                self.input_content += cmd.combine(
                    label, [feature], [1 / rng[i]], [mean[i]]
                )
                normalized_labels.append(label)
        else:
            normalized_labels = list(self.features_list)

        self.input_content += "\n# Collective variable\n"
        cv_labels = []
        for i in range(weights.shape[1]):
            name = f"{p['cv_name']}_{i}"
            self.input_content += cmd.combine(name, normalized_labels, weights[:, i])
            cv_labels.append(name)

        stats = p["cv_stats"]
        cv_offset = (np.asarray(stats["min"]) + np.asarray(stats["max"])) / 2
        cv_scale = 2 / (np.asarray(stats["max"]) - np.asarray(stats["min"]))
        self.input_content += "\n# Normalized Collective variable\n"
        normalized_cv_labels = []
        for i in range(weights.shape[1]):
            name = f"norm_{p['cv_name']}_{i}"
            self.input_content += cmd.combine(
                name, [cv_labels[i]], [cv_scale[i]], [cv_offset[i]]
            )
            normalized_cv_labels.append(name)
        self.cv_labels = normalized_cv_labels

    def add_non_linear_cv(self) -> None:
        """PYTORCH_MODEL action over the raw features (normalization lives
        inside the exported model; cf. assembler.py:417-447)."""
        p = self.cv_params
        for key in ("weights_path", "cv_dimension"):
            if key not in p:
                raise ValueError(f"Non-linear CV requires {key}.")
        p.setdefault("cv_name", "cv")
        self.input_content += "\n# Collective variable\n"
        self.input_content += cmd.pytorch_model(
            p["cv_name"], self.features_list, os.path.basename(p["weights_path"])
        )
        self.cv_labels = [
            f"{p['cv_name']}.node-{i}" for i in range(p["cv_dimension"])
        ]


class EnhancedSamplingAssembler(CollectiveVariableAssembler):
    """Adds the enhanced-sampling section: wt-metadynamics / OPES variants +
    optional waypoint RMSD restraint wall (cf. assembler.py:449-616)."""

    def __init__(
        self,
        plumed_input_path: str,
        topology_path: str,
        features_list: List[str],
        traj_stride: int,
        cv_type: str,
        cv_params: Dict,
        sampling_method: str,
        sampling_params: Dict,
        fit_template_path: Optional[str] = None,
        rmsd_restraint_reference_path: Optional[str] = None,
        rmsd_restraint_k: Optional[float] = None,
        rmsd_restraint_eq: Optional[float] = None,
    ):
        super().__init__(
            plumed_input_path, topology_path, features_list, traj_stride,
            cv_type, cv_params, fit_template_path,
        )
        self.sampling_method = sampling_method
        self.sampling_params = sampling_params
        self.rmsd_restraint_reference_path = rmsd_restraint_reference_path
        self.rmsd_restraint_k = rmsd_restraint_k
        self.rmsd_restraint_eq = rmsd_restraint_eq
        self.bias_labels: List[str] = []

    def build(self) -> None:
        super().build()
        self.add_enhanced_sampling_section()

    def add_enhanced_sampling_section(self) -> None:
        if self.sampling_method == "wt_metadynamics":
            self.add_wt_metadynamics()
        elif self.sampling_method == "opes_metad":
            self.add_opes(cmd.opes_metad, "opes_metad", ".bias")
        elif self.sampling_method == "opes_metad_explore":
            self.add_opes(cmd.opes_metad_explore, "opes_metad_explore", ".bias")
        elif self.sampling_method == "opes_expanded":
            self.add_opes_expanded()
        else:
            raise ValueError(
                f"Enhanced sampling method {self.sampling_method} not recognized."
            )
        self.add_rmsd_restraint()

    def add_rmsd_restraint(self) -> None:
        if self.rmsd_restraint_reference_path is None:
            return
        rmsd_label = "rmsd_restraint"
        self.input_content += "\n# RMSD Restraint\n"
        self.input_content += cmd.rmsd(
            rmsd_label, os.path.basename(self.rmsd_restraint_reference_path)
        )
        wall_label = "rmsd_restraint_wall"
        self.input_content += cmd.upper_walls(
            wall_label,
            arguments=[rmsd_label],
            at_eqs=[float(self.rmsd_restraint_eq)],
            kappas=[float(self.rmsd_restraint_k)],
        )
        self.print_args.extend([rmsd_label, wall_label])

    def add_wt_metadynamics(self) -> None:
        if not self.cv_type:
            raise ValueError("Enhanced sampling requires a collective variable.")
        dim = self.cv_params["cv_dimension"]
        sp = self.sampling_params
        self.input_content += "\n# Enhanced Sampling\n"
        self.input_content += cmd.metad(
            command_label="wt_metad",
            arguments=self.cv_labels,
            sigmas=[sp["sigma"]] * dim,
            height=sp["height"],
            bias_factor=sp["bias_factor"],
            temperature=sp["temperature"],
            pace=sp["pace"],
            grid_mins=[sp["grid_min"]] * dim,
            grid_maxs=[sp["grid_max"]] * dim,
            grid_bins=[sp["grid_bin"]] * dim,
        )
        self.bias_labels.append("wt_metad.rbias")

    def add_opes_expanded(self) -> None:
        """OPES_EXPANDED over a line of umbrella ECVs spanning the CV range.

        Exported CVs are min-max normalized to [-1, 1] (LinearCalculator CV
        normalization / the Normalization postprocessing baked into deep-CV
        exports), so the umbrella line spans exactly that range; sigma is the
        configured kernel width. Goes beyond the reference, whose
        add_opes_expanded raises NotImplementedError (assembler.py:610-616).
        """
        if not self.cv_type:
            raise ValueError("Enhanced sampling requires a collective variable.")
        dim = self.cv_params["cv_dimension"]
        sp = self.sampling_params
        self.input_content += "\n# Enhanced Sampling\n"
        ecv_label = "ecv_umb"
        self.input_content += cmd.ecv_umbrellas_line(
            command_label=ecv_label,
            arguments=self.cv_labels,
            temperature=sp["temperature"],
            cv_mins=[-1.0] * dim,
            cv_maxs=[1.0] * dim,
            sigmas=[sp["sigma"]] * dim,
            barrier=sp["barrier"],
        )
        self.input_content += cmd.opes_expanded(
            command_label="opes_expanded",
            arguments=[f"{ecv_label}.*"],
            pace=sp["pace"],
            observation_steps=sp["observation_steps"],
        )
        self.bias_labels.append("opes_expanded.bias")

    def add_opes(self, builder, bias_name: str, suffix: str) -> None:
        if not self.cv_type:
            raise ValueError("Enhanced sampling requires a collective variable.")
        dim = self.cv_params["cv_dimension"]
        sp = self.sampling_params
        self.input_content += "\n# Enhanced Sampling\n"
        self.input_content += builder(
            command_label=bias_name,
            arguments=self.cv_labels,
            temperature=sp["temperature"],
            pace=sp["pace"],
            sigmas=[sp["sigma"]] * dim,
            barrier=sp["barrier"],
            compression_threshold=sp["compression_threshold"],
        )
        self.bias_labels.append(f"{bias_name}{suffix}")
