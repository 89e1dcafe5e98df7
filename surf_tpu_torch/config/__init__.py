from .hocon import (ConfigFactory, ConfigTree, ConfigMissingException, dump_string, parse_file,
                    parse_string)

__all__ = [
    "ConfigFactory",
    "ConfigTree",
    "ConfigMissingException",
    "dump_string",
    "parse_file",
    "parse_string",
]
