from .registry import Config, ConfigError  # noqa: F401
