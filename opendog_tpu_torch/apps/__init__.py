"""Robot applications of the port: the wire-level MPC and student bridges
(:mod:`.mpc_bridge`), the on-robot policy loop (:mod:`.run_policy`), the
scripted gait behaviours (:mod:`.gaits`), and perception: sim depth and
ICP localization (:mod:`.slam`), the voxel map (:mod:`.mapping`),
obstacles and avoidance (:mod:`.obstacle`), the monocular depth CNN
(:mod:`.mono_depth`) behind the depth display loop (:mod:`.depth`), and the
headless point-cloud viewer (:mod:`.pointcloud_viz`).  The JAX package's
other apps (voice, the other viewers, dashboards) are not ported yet."""
from .gaits import (  # noqa: F401
    autocorrect_trot_cycle,
    motor_bringup,
    play_gait,
    safe_shutdown,
    stabilization_targets,
    stabilize,
    stance_vector,
    walk_straight,
)
from .mpc_bridge import (  # noqa: F401
    MPCBridge,
    StudentBridge,
    make_bridge,
    read_measured_angles,
)
from .run_policy import (  # noqa: F401
    action_to_target_degrees,
    build_observation,
    run_policy_loop,
    VelocityEstimator,
)
from .depth import depth_stream, normalize_depth  # noqa: F401
from .mapping import DeadReckoner, VoxelMap, transform_points  # noqa: F401
from .mono_depth import (  # noqa: F401
    DepthCNN,
    load_flax_depth_params,
    make_sim_predictor,
    render_shaded,
    render_shaded_overcast,
    train_depth_net,
)
from .obstacle import (  # noqa: F401
    AvoidState,
    ObstacleAvoider,
    detect_obstacles,
    render_avoidance_frame,
)
from .pointcloud_viz import (  # noqa: F401
    orbit_frames,
    render_cloud_frame,
    voxel_downsample,
)
from .slam import (  # noqa: F401
    CamConfig,
    TerrainLocalizer,
    point_to_plane_icp,
    render_depth,
    simulate_walk_localization,
)
