"""Every default of the port equals the JAX package's, and every
parameter of the JAX package is taken.

For each public function and dataclass of `tpufoam_torch` whose
counterpart of the same module path and name in `tpufoam` has a
parameter (or field) of the same name, and where both give it a default,
the two defaults are equal. Each such function and dataclass takes every
parameter (field) of its counterpart, but for the names listed in
`UNPORTED` (each with the ROADMAP.md section A item that ports it) and
`DELIBERATE` (a difference by design). The port names the JAX package's smoother
values differently, so "xla", "pallas" and "pallas-fused" compare equal to
"plain", "kernel" and "kernel-fused". A default that is itself a
dataclass instance (a config, a backend) compares by its class name and by
the defaults of the fields both classes have.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import pytest

import tpufoam_torch

SMOOTHER_NAMES = {"xla": "plain", "pallas": "kernel",
                  "pallas-fused": "kernel-fused"}


def _defaults(obj) -> dict:
    if inspect.isclass(obj) and dataclasses.is_dataclass(obj):
        return {f.name: f.default for f in dataclasses.fields(obj)
                if f.default is not dataclasses.MISSING}
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return {}
    return {k: p.default for k, p in params.items()
            if p.default is not inspect.Parameter.empty}


def _same(port, ref) -> bool:
    if isinstance(ref, str):
        return port == SMOOTHER_NAMES.get(ref, ref)
    if dataclasses.is_dataclass(ref) and not isinstance(ref, type):
        if type(port).__name__ != type(ref).__name__:
            return False
        names = ({f.name for f in dataclasses.fields(port)}
                 & {f.name for f in dataclasses.fields(ref)})
        return all(_same(getattr(port, n), getattr(ref, n)) for n in names)
    return type(port) is type(ref) and port == ref


def _pairs():
    """(qualified name, port object, JAX object) of every public function
    and class of the port with a JAX counterpart."""
    for info in pkgutil.walk_packages(tpufoam_torch.__path__,
                                      "tpufoam_torch."):
        mod = importlib.import_module(info.name)
        try:
            jmod = importlib.import_module(
                "tpufoam" + info.name[len("tpufoam_torch"):])
        except ImportError:
            continue
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("_") or not (inspect.isfunction(obj)
                                            or inspect.isclass(obj)):
                continue
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            ref = getattr(jmod, name, None)
            if ref is not None:
                yield f"{info.name}.{name}", obj, \
                    getattr(ref, "__wrapped__", ref)


PAIRS = list(_pairs())

# Parameters and fields of the JAX package's functions and dataclasses
# that the port does not take yet, each with the ROADMAP.md section A
# item that ports it. A call that passes one raises TypeError. None is
# left: the last, jax.sharding.Mesh's axis_types, is Mesh.axis_types.
UNPORTED: dict = {}
ROADMAP_A_ITEMS: set = set()
# Differences by design: the port's DistributedConfig takes torchrun's
# names (master_addr, master_port, world_size, rank) for what JAX's
# distributed initialisation calls these.
# flax modules are dataclasses whose `parent` and `name` place them in a
# module tree; the port's are torch.nn.Modules, which take their input
# width instead of inferring it.
DELIBERATE = {"parallel.distributed.DistributedConfig": {
    "coordinator_address", "num_processes", "process_id"},
    **{f"models.pointnet.{c}": {"parent", "name"}
       for c in ("ConvBN", "DenseBN", "TNet", "Inception", "PointNetUNet")}}


def test_the_walk_finds_the_entry_points():
    names = {n for n, _, _ in PAIRS}
    for entry in ("piso.engine.piso_step", "piso.engine.run_piso_eager",
                  "piso.engine.PisoConfig", "piso.batched.run_piso_batched",
                  "piso.batched.run_piso_batched_eager",
                  "fv.momentum.jacobi_momentum",
                  "fv.momentum.momentum_coeffs",
                  "piso.engine.run_piso_chunked",
                  "fv.case.save_flow", "fv.case.load_flow",
                  "fv.forces.obstacle_force",
                  "eval.benchmark.schafer_turek_case",
                  "eval.benchmark.run_force_series",
                  "eval.benchmark.load_run_state",
                  "eval.benchmark.summarize_2d3",
                  "surrogate.pipeline.make_predictor",
                  "solvers.backends.MGBackend",
                  "solvers.backends.AutoBackend",
                  "core.grid.graded_spacing", "core.grid.make_graded_grid",
                  "fv.momentum.wall_unit_normal",
                  "fv.momentum.wall_normal_release",
                  "fv.momentum.wall_shear2_source",
                  "piso.engine.run_piso",
                  "models.mlp.ModelDef", "models.mlp.define_model_arch",
                  "models.mlp.l2_penalty", "models.mlp.count_params",
                  "surrogate.pca.PCAModel",
                  "surrogate.features.masked_gradient",
                  "surrogate.features.smart_arcsinh",
                  "surrogate.features.poisson_source",
                  "surrogate.features.f_u_term",
                  "surrogate.blocks.gaussian_filter2d",
                  "surrogate.blocks.apply_deltaU_weighting",
                  "surrogate.pipeline.surrogate_blocks_forward",
                  "surrogate.gradp_integrate.integrate_gradp",
                  "fv.turbulence.TurbState", "fv.turbulence.init_turbulence",
                  "fv.turbulence.sst_step", "fv.turbulence.wall_cell_masks",
                  "fv.momentum.wall_conductance",
                  "piso.engine.piso_step_sst", "piso.engine.run_piso_sst",
                  "piso.engine.run_piso_sst_eager",
                  "fv.case.load_turbulence", "eval.benchmark.dean_cf",
                  "eval.benchmark.turbulent_channel_case",
                  "eval.benchmark.channel_wall_cf",
                  "eval.benchmark.save_run_state",
                  "parallel.mesh.shard_turbulence",
                  "parallel.mesh.make_sharded_sst_step",
                  "surrogate.pca.StreamingPCA", "surrogate.pca.fit_pca_exact",
                  "models.mlp.init_model", "models.mlp.apply_model",
                  "surrogate.features.FamilyConfig",
                  "surrogate.pipeline.SurrogateBundle",
                  "train.sampler.lhs_sample",
                  "train.sampler.sample_block_corners",
                  "train.sampler.gather_training_blocks",
                  "train.dataset.BlockDataset",
                  "train.dataset.frame_is_relevant",
                  "train.dataset.build_block_dataset",
                  "train.dataset.save_block_dataset",
                  "train.dataset.load_block_dataset",
                  "train.dataset.frames_from_rollout",
                  "train.dataset.frames_from_sst_rollout",
                  "train.trainer.TrainConfig", "train.trainer.TrainState",
                  "train.trainer.mse_loss_1e6", "train.trainer.fit_pcas",
                  "train.trainer.encode_dataset",
                  "train.trainer.normalize_pc_space",
                  "train.trainer.relative_change_early_stop",
                  "train.trainer.save_checkpoint",
                  "train.trainer.load_checkpoint",
                  "train.trainer.train_surrogate",
                  "parallel.mesh.mlp_partition_specs",
                  "parallel.mesh.make_sharded_train_step",
                  "utils.metrics.ErrorReport", "utils.metrics.error_metrics",
                  "eval.evaluation.EvalReport",
                  "eval.evaluation.evaluate_bundle",
                  "core.sdf.domain_and_sdf", "core.grid.scatter_to_grid",
                  "core.grid.gather_from_grid",
                  "surrogate.blocks.extract_blocks_gather",
                  "solvers.backends.PressureBackend",
                  "core.interp.ResampleOp", "core.interp.build_resample",
                  "core.interp.apply_resample", "utils.hdf5_io.SimFrame",
                  "utils.hdf5_io.write_dataset", "utils.hdf5_io.read_frame",
                  "utils.hdf5_io.rollout_to_records",
                  "eval.evaluation.UnstructuredCase",
                  "models.keras_compat.load_keras_dense_h5",
                  "surrogate.reference_io.load_sklearn_ipca",
                  "surrogate.reference_io.bundle_from_reference_sidecars",
                  "surrogate.reference_io.export_reference_sidecars",
                  "bridge.server.BridgeServer", "bridge.server.serve",
                  "cli.piso_main", "cli.casegen_main", "cli.datagen_main",
                  "cli.train_main", "cli.pinn_main", "cli.pointcloud_main",
                  "cli.eval_main", "cli.bundle_main",
                  "models.pinn.PinnConfig", "models.pinn.init_pinn",
                  "models.pinn.uvp_fn", "models.pinn.pinn_loss",
                  "models.pinn.make_training_points",
                  "models.pinn.train_pinn", "models.pinn.save_pinn_h5",
                  "models.pinn.load_pinn_h5", "models.pointnet.ConvBN",
                  "models.pointnet.DenseBN", "models.pointnet.TNet",
                  "models.pointnet.Inception",
                  "models.pointnet.PointNetUNet",
                  "models.pointnet.masked_mse",
                  "models.pointnet.pointnet_loss",
                  "train.pointcloud.PointCloudDataset",
                  "train.pointcloud.build_pointcloud_dataset",
                  "train.pointcloud.train_pointcloud",
                  "eval.pointcloud_rollout.rollout",
                  "eval.pointcloud_rollout.rasterize",
                  "eval.pointcloud_rollout.rollout_report",
                  "data.casegen.write_blockmesh_dict",
                  "data.casegen.write_openfoam_case",
                  "data.casegen.write_mirror_mesh_dict",
                  "data.blockmesh.MeshSpec2D", "data.blockmesh.write_spec",
                  "data.blockmesh.cylinder_spec",
                  "utils.determinism.enable_determinism",
                  "utils.h5ckpt.save_pytree_h5",
                  "utils.h5ckpt.load_pytree_h5",
                  "utils.plotting.plot_fields",
                  "utils.plotting.save_eval_plots",
                  "utils.plotting.plot_loss_history",
                  "utils.profiling.StageTimer", "utils.profiling.trace",
                  "utils.profiling.memory_report",
                  "utils.vtk_io.read_legacy_vtk",
                  "utils.vtk_io.write_legacy_vtk"):
        assert f"tpufoam_torch.{entry}" in names, entry


def test_piso_config_has_the_ported_fields_only():
    """Every field of the JAX package's config is there, in its order, and
    no other: a field the port lacked would raise when set, one it added
    would be one the JAX package ignores."""
    from tpufoam.piso.engine import PisoConfig as JaxConfig
    from tpufoam_torch.piso.engine import PisoConfig
    port = [f.name for f in dataclasses.fields(PisoConfig)]
    ref = [f.name for f in dataclasses.fields(JaxConfig)]
    assert port == ref
    assert PisoConfig(turb_wall_fn=True).turb_wall_fn is True
    with pytest.raises(TypeError):
        PisoConfig(wall_functions=True)


@pytest.mark.parametrize("name,port,ref", PAIRS, ids=[p[0] for p in PAIRS])
def test_defaults_equal_the_jax_packages(name, port, ref):
    pd, rd = _defaults(port), _defaults(ref)
    differ = {k: (pd[k], rd[k]) for k in pd.keys() & rd.keys()
              if not _same(pd[k], rd[k])}
    assert not differ, f"{name}: (port, JAX) defaults differ: {differ}"


def _names(obj) -> list:
    """The fields of a dataclass, else the parameters of its signature."""
    if inspect.isclass(obj) and dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return []


@pytest.mark.parametrize("name,port,ref", PAIRS, ids=[p[0] for p in PAIRS])
def test_the_port_takes_every_jax_parameter(name, port, ref):
    """Every parameter (field) of the JAX counterpart is taken, but for
    the listed gaps; a listed gap that the port now takes must leave the
    list, so the list stays the truth."""
    short = name[len("tpufoam_torch."):]
    missing = set(_names(ref)) - set(_names(port))
    listed = set(UNPORTED.get(short, {})) | DELIBERATE.get(short, set())
    assert missing == listed, (
        f"{name}: the port lacks {sorted(missing - listed)} (unlisted) "
        f"and takes {sorted(listed - missing)} (listed as missing)")


def test_every_gap_is_tied_to_a_roadmap_item():
    names = {n[len("tpufoam_torch."):] for n, _, _ in PAIRS}
    assert set(UNPORTED) | set(DELIBERATE) <= names
    assert not set(UNPORTED) & set(DELIBERATE)
    for gaps in UNPORTED.values():
        assert set(gaps.values()) <= ROADMAP_A_ITEMS, gaps

