from .control import KeyboardFlyControl, FlyPathControl, FlyPathFrame
from .engine import Engine, EngineStatus
