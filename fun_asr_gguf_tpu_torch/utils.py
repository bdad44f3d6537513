"""Small shared utilities (reference ``fun_asr_gguf/utils.py``)."""


def vprint(message: str, verbose: bool = True):
    """Conditional print."""
    if verbose:
        print(message)


def format_ms(seconds: float) -> str:
    """Seconds -> right-aligned millisecond string."""
    return f"{seconds * 1000:5.0f}ms"
