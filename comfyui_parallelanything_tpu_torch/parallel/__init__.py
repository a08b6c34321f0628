from .streaming import StreamingRunner, build_streaming_runner

__all__ = ["StreamingRunner", "build_streaming_runner"]
