"""The serving stack of the port (the JAX package's rsvldm_tpu/serving):
the controller, the SR and LLM workers, the continuous-batching engine,
the web frontend and the chat CLI."""

from .controller import Controller
from .worker import Worker
from .web import WebServer
from .cli import ChatSession
from .engine import DecodeEngine
from .llm_worker import LLMWorker
