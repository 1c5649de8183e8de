"""Robot applications of the port: the wire-level MPC and student bridges
(:mod:`.mpc_bridge`), the on-robot policy loop (:mod:`.run_policy`) and the
scripted gait behaviours (:mod:`.gaits`).  The JAX package's other apps
(perception, voice, viewers, dashboards) are not ported yet."""
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
