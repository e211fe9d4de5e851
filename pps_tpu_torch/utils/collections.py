"""AttrDict: a dict with attribute access and immutability support.

Counterpart of ``pps_tpu/utils/collections.py``; the same container the
reference config system uses, so yaml configs and ``KEY VALUE`` override
lists keep working unchanged.
"""


class AttrDict(dict):
    """Dictionary whose items are also accessible as attributes.

    Immutability is recursive: once ``immutable(True)`` is called, attribute
    and item assignment raise AttributeError until it is lifted again.
    """

    _IMMUTABLE = "__immutable__"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__[AttrDict._IMMUTABLE] = False

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.__dict__[AttrDict._IMMUTABLE]:
            raise AttributeError(
                "Attempted to set '{}' to '{}', but AttrDict is immutable".format(
                    name, value
                )
            )
        self[name] = value

    def __setitem__(self, name, value):
        if self.__dict__.get(AttrDict._IMMUTABLE, False):
            raise AttributeError(
                "Attempted to set '{}' to '{}', but AttrDict is immutable".format(
                    name, value
                )
            )
        super().__setitem__(name, value)

    def immutable(self, is_immutable):
        """Recursively set immutability."""
        self.__dict__[AttrDict._IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)
        for v in self.__dict__.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)

    def is_immutable(self):
        return self.__dict__[AttrDict._IMMUTABLE]
