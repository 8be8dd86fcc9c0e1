from deepmimic_mujoco_torch.envs.types import EnvState  # noqa: F401
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3  # noqa: F401
from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi  # noqa: F401
from deepmimic_mujoco_torch.envs.dp_env_v2 import DPEnvV2  # noqa: F401
from deepmimic_mujoco_torch.envs.dp_env_v1 import DPEnvV1  # noqa: F401
from deepmimic_mujoco_torch.envs.humanoid_test_env import HumanoidTestEnv  # noqa: F401
from deepmimic_mujoco_torch.envs.deepmimic_surface import DeepMimicSurfaceEnv  # noqa: F401
from deepmimic_mujoco_torch.envs.vector import VectorEnv  # noqa: F401
