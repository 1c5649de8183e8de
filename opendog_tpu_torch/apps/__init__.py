"""Robot applications of the port: the wire-level MPC and student bridges
(:mod:`.mpc_bridge`), the on-robot policy loop (:mod:`.run_policy`), the
scripted gait behaviours (:mod:`.gaits`), and perception: sim depth and
ICP localization (:mod:`.slam`), the voxel map (:mod:`.mapping`),
obstacles and avoidance (:mod:`.obstacle`), the monocular depth CNN
(:mod:`.mono_depth`) behind the depth display loop (:mod:`.depth`), and the
headless point-cloud viewer (:mod:`.pointcloud_viz`); the voice front end
(:mod:`.voice`, :mod:`.voice_frontend`, :mod:`.voice_synth2`), behaviour
cloning (:mod:`.cloning`), policy introspection (:mod:`.nnvis`), the
keyboard driver of the simulation viewer (:mod:`.viewer_cli`), motor
calibration (:mod:`.calibration`), the telemetry dashboards
(:mod:`.dashboard`), the IMU visualizer (:mod:`.imu_viz`) and the camera
stream viewer (:mod:`.camera_viewer`)."""
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
from .calibration import (  # noqa: F401
    PIDGains,
    analyze_response,
    firmware_power,
    simulate_pid_response,
    step_response,
)
from .camera_viewer import CameraViewer  # noqa: F401
from .cloning import (  # noqa: F401
    WalkPolicyNet,
    cloned_lift_angles,
    expert_action,
    train_cloned_policy,
)
from .dashboard import (  # noqa: F401
    render_terminal_dashboard,
    serve_web_dashboard,
    snapshot_from_body,
)
from . import imu_viz  # noqa: F401
from .nnvis import (  # noqa: F401
    activation_summary,
    capture_activations,
    render_activation_dashboard,
)
from .viewer_cli import build_viewer, handle  # noqa: F401
from .voice import (  # noqa: F401
    GaitMode,
    RobotCommand,
    VoiceGaitMachine,
    parse_command,
)
from .voice_frontend import (  # noqa: F401
    KeywordSpotter,
    log_mel,
    make_dtw_transcriber,
    segment_stream,
    synthesize_phrase,
    synthesize_word,
)
from .voice_synth2 import (  # noqa: F401
    lpc_synthesize_phrase,
    lpc_synthesize_word,
)
