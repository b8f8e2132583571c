"""Error helper (reference: util/check.go:3-7)."""


def check(err):
    """Raise if ``err`` is an exception instance; mirror of util.Check."""
    if isinstance(err, BaseException):
        raise err
