"""YAML experiment configs and the CLI (port of quant_tpu/config)."""

from quant_tpu_torch.config.parser import (
    check_single_card, get_base_argument_parser, parse_common_fields,
    parse_config,
)

__all__ = ['check_single_card', 'get_base_argument_parser',
           'parse_common_fields', 'parse_config']
