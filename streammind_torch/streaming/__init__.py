from .engine import DEFAULT_BUCKETS, StreamMindEngine, StreamSession
from .state import StreamState, init_stream_state
