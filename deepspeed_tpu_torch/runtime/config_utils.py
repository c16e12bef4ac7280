"""Config plumbing shared by the port's config sections.

A trimmed copy of ``deepspeed_tpu/runtime/config_utils.py``: the pydantic
base model that resolves ``"auto"`` leaves to their defaults and tolerates
unknown keys with a warning, so configs written for the JAX package keep
loading.
"""

from __future__ import annotations

import logging
from typing import Any

from pydantic import BaseModel, ConfigDict, model_validator

logger = logging.getLogger(__name__)

AUTO = "auto"


class DeepSpeedConfigModel(BaseModel):
    """Base class for every config section model."""

    model_config = ConfigDict(extra="allow", populate_by_name=True, validate_assignment=True,
                              arbitrary_types_allowed=True, protected_namespaces=())

    @model_validator(mode="before")
    @classmethod
    def _resolve_auto(cls, values: Any) -> Any:
        if not isinstance(values, dict):
            return values
        values = dict(values)
        for name, field in cls.model_fields.items():
            for k in (field.alias or name, name):
                if k in values and isinstance(values[k], str) and values[k] == AUTO:
                    values[k] = (field.default_factory()
                                 if field.default_factory is not None
                                 else field.default)
        return values

    def model_post_init(self, __context: Any) -> None:
        for key in getattr(self, "model_extra", None) or {}:
            logger.warning("%s: ignoring unknown config key '%s'", type(self).__name__, key)
