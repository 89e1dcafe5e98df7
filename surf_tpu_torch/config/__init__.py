from .hocon import ConfigFactory, ConfigTree, ConfigMissingException, parse_file, parse_string

__all__ = [
    "ConfigFactory",
    "ConfigTree",
    "ConfigMissingException",
    "parse_file",
    "parse_string",
]
