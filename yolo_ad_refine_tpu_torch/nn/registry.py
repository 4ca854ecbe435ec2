"""Name -> module-class registry used by the yaml model compiler."""

MODULE_REGISTRY: dict[str, type] = {}


def register(cls=None, *, name: str | None = None, aliases: tuple[str, ...] = ()):
    """Class decorator registering a module under its yaml name."""

    def wrap(c):
        MODULE_REGISTRY[name or c.__name__] = c
        for a in aliases:
            MODULE_REGISTRY[a] = c
        return c

    return wrap(cls) if cls is not None else wrap
