from .broker import BatchedSessionBroker
