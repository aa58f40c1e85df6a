"""Multi-turn chat prompt construction for each supported LLM family.

Re-design of the reference's five PromptBuilder classes
(reference: prismatic/models/backbones/llm/prompting/{base_prompter.py:11-73,
llama2_chat_prompter.py, vicuna_v15_prompter.py:14-50,
mistral_instruct_prompter.py, phi_prompter.py}) as a single data-driven
builder: a `PromptFormat` spec holds the role wrappers / system-prompt rule /
BOS handling, and one `PromptBuilder` implements the turn state machine. Output
strings are byte-identical to the reference formats — these feed the tokenizer
and therefore the model's training distribution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

# System prompts (reference: llama2_chat_prompter.py SYS_PROMPTS,
# vicuna_v15_prompter.py SYS_PROMPTS — identical for "prismatic" and "openvla").
LLAMA2_CHAT_SYS_PROMPT = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)
VICUNA_SYS_PROMPT = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)


@dataclass(frozen=True)
class PromptFormat:
    """Declarative chat format for one LLM family."""

    bos: str
    eos: str
    wrap_human: Callable[[str], str]
    # gpt wrap gets (message, eos); empty messages render as a single space.
    wrap_gpt: Callable[[str, str], str]
    default_system_prompt: Optional[str] = None
    # How the system prompt joins the first human turn:
    #   "inside"  -> wrap_human(system + msg)   (llama2-chat [INST] style)
    #   "prefix"  -> system + wrap_human(msg)   (vicuna style)
    #   None      -> no system prompt           (pure / mistral / phi)
    system_mode: Optional[str] = None
    # Phi's tokenizer does not auto-insert BOS, so the builder prepends it and
    # get_prompt() must NOT strip it (reference: phi_prompter.py:36-40,74-75).
    explicit_bos: bool = False

    def format_system(self, system_prompt: str) -> str:
        if self.system_mode == "inside":
            return f"<<SYS>\n{system_prompt.strip()}\n<</SYS>>\n\n"
        return system_prompt.strip() + " "


def _gpt_wrap(msg: str, eos: str) -> str:
    return f"{msg if msg != '' else ' '}{eos}"


PROMPT_FORMATS: Dict[str, PromptFormat] = {
    # "In: ...\nOut: " — the VLA training format (reference: base_prompter.py:28-73)
    "pure": PromptFormat(
        bos="<s>",
        eos="</s>",
        wrap_human=lambda msg: f"In: {msg}\nOut: ",
        wrap_gpt=_gpt_wrap,
    ),
    "llama2-chat": PromptFormat(
        bos="<s>",
        eos="</s>",
        wrap_human=lambda msg: f"[INST] {msg} [/INST] ",
        wrap_gpt=_gpt_wrap,
        default_system_prompt=LLAMA2_CHAT_SYS_PROMPT,
        system_mode="inside",
    ),
    "vicuna-v15": PromptFormat(
        bos="<s>",
        eos="</s>",
        wrap_human=lambda msg: f"USER: {msg} ASSISTANT: ",
        wrap_gpt=_gpt_wrap,
        default_system_prompt=VICUNA_SYS_PROMPT,
        system_mode="prefix",
    ),
    "mistral-instruct": PromptFormat(
        bos="<s>",
        eos="</s>",
        wrap_human=lambda msg: f"[INST] {msg} [/INST] ",
        wrap_gpt=_gpt_wrap,
    ),
    "phi": PromptFormat(
        bos="<|endoftext|>",
        eos="<|endoftext|>",
        wrap_human=lambda msg: f"Input: {msg}\nOutput: ",
        wrap_gpt=lambda msg, eos: f"{msg if msg != '' else ' '}\n{eos}",
        explicit_bos=True,
    ),
}


class PromptBuilder:
    """Stateful multi-turn prompt accumulator (human/gpt alternating)."""

    def __init__(self, format_id: str, model_family: str = "openvla", system_prompt: Optional[str] = None):
        if format_id not in PROMPT_FORMATS:
            raise KeyError(f"Unknown prompt format {format_id!r}; available: {sorted(PROMPT_FORMATS)}")
        self.format_id, self.model_family = format_id, model_family
        self.fmt = PROMPT_FORMATS[format_id]
        sp = system_prompt if system_prompt is not None else self.fmt.default_system_prompt
        self.system_prompt = self.fmt.format_system(sp) if (sp is not None and self.fmt.system_mode) else None
        self.prompt, self.turn_count = "", 0

    @property
    def bos(self) -> str:
        return self.fmt.bos

    @property
    def eos(self) -> str:
        return self.fmt.eos

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt"), (
            f"Expected {'human' if self.turn_count % 2 == 0 else 'gpt'} turn, got {role!r}"
        )
        message = message.replace("<image>", "").strip()

        if self.turn_count % 2 == 0:  # human
            wrapped = self.fmt.wrap_human(message)
            if self.turn_count == 0:
                if self.system_prompt is not None:
                    if self.fmt.system_mode == "inside":
                        wrapped = self.fmt.wrap_human(self.system_prompt + message)
                    else:  # prefix
                        wrapped = self.system_prompt + wrapped
                if self.fmt.explicit_bos:
                    wrapped = f"{self.fmt.bos}{wrapped}"
        else:  # gpt
            wrapped = self.fmt.wrap_gpt(message, self.fmt.eos)

        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        """Prompt as-if `message` were the next human turn (no state change)."""
        probe = self.prompt + self.fmt.wrap_human(message)
        if not self.fmt.explicit_bos:
            probe = probe.removeprefix(self.fmt.bos)
        return probe.rstrip()

    def get_prompt(self) -> str:
        # Strip leading BOS for families whose tokenizer auto-inserts it.
        p = self.prompt if self.fmt.explicit_bos else self.prompt.removeprefix(self.fmt.bos)
        return p.rstrip()


def get_prompt_builder(llm_family: str, model_family: str = "openvla", system_prompt: Optional[str] = None) -> PromptBuilder:
    """Map an LLM backbone family to its prompt format (reference: per-backbone
    `prompt_builder_fn` properties, e.g. llama2.py:84-97)."""
    format_id = {
        "llama2-pure": "pure",
        "llama2-chat": "llama2-chat",
        "vicuna": "vicuna-v15",
        "mistral-pure": "pure",
        "mistral-instruct": "mistral-instruct",
        "phi": "phi",
        "deepseek-v2-pure": "pure",
    }.get(llm_family, llm_family)
    return PromptBuilder(format_id, model_family=model_family, system_prompt=system_prompt)


def build_vla_prompt(instruction: str, llm_family: str = "llama2-pure", openvla_v01: bool = False) -> str:
    """The canonical VLA inference prompt (reference: vlas/openvla.py:35-58,
    vla-scripts/deploy.py:58-62). v01 models use the Vicuna chat wrapper."""
    if openvla_v01:
        b = PromptBuilder("vicuna-v15")
        b.add_turn("human", f"What action should the robot take to {instruction.lower()}?")
        return b.get_prompt()
    return f"In: What action should the robot take to {instruction.lower()}?\nOut:"
