"""kllms-check rule modules. Importing this package registers every rule
with :data:`k_llms_tpu_torch.analysis.framework.RULES` via the ``@register``
decorators — the framework imports it lazily from ``_ensure_rules_loaded``."""

from . import contracts, guardedby, hotpath, locks  # noqa: F401
