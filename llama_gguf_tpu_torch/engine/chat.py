"""Chat template handling (a copy of llama_gguf_tpu/engine/chat.py).

Detects ChatML / Llama2 / Llama3 / Gemma / Phi / plain User-Assistant from
the vocab, and renders the GGUF's embedded Jinja `tokenizer.chat_template`
when jinja2 imports. jinja2 is imported only to render; without it a GGUF
with an embedded template renders by its vocab style.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence


@dataclass
class ChatTemplate:
    style: str  # chatml | llama2 | llama3 | gemma | phi | plain | jinja
    jinja_source: str | None = None

    @classmethod
    def detect(cls, tokenizer) -> "ChatTemplate":
        src = getattr(tokenizer, "chat_template", None)
        if src and _jinja_available():
            return cls("jinja", src)
        vocab = set(getattr(tokenizer, "tokens", []) or [])
        if "<|im_start|>" in vocab:
            return cls("chatml")
        if "<|start_header_id|>" in vocab:
            return cls("llama3")
        if "<start_of_turn>" in vocab:
            return cls("gemma")
        if "<|user|>" in vocab and "<|assistant|>" in vocab:
            return cls("phi")
        if "[INST]" in vocab or "▁[INST]" in vocab:
            return cls("llama2")
        return cls("plain")

    @property
    def stop(self) -> tuple[str, ...]:
        """Style-specific stop strings (safety net on top of EOG tokens)."""
        return {
            "chatml": ("<|im_end|>",),
            "llama3": ("<|eot_id|>",),
            "gemma": ("<end_of_turn>",),
            "phi": ("<|end|>",),
            "plain": ("\nUser:",),
        }.get(self.style, ())

    def render(self, messages: Sequence[dict[str, Any]],
               add_generation_prompt: bool = True,
               tools: Sequence[dict] | None = None) -> str:
        if self.style == "jinja":
            return self._render_jinja(messages, add_generation_prompt, tools)
        if tools:
            # non-jinja fallback: describe tools in a system message
            import json as _json

            desc = (
                "You have access to the following tools. To call one, "
                "respond ONLY with JSON of the form "
                '{"name": <tool name>, "arguments": <args object>}.\n'
                + "\n".join(
                    f"- {t['function']['name']}: "
                    f"{t['function'].get('description', '')} "
                    f"parameters: {_json.dumps(t['function'].get('parameters', {}))}"
                    for t in tools
                )
            )
            messages = [{"role": "system", "content": desc}] + list(messages)
        if self.style == "chatml":
            out = []
            for m in messages:
                out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
            if add_generation_prompt:
                out.append("<|im_start|>assistant\n")
            return "".join(out)
        if self.style == "llama3":
            out = ["<|begin_of_text|>"]
            for m in messages:
                out.append(
                    f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                    f"{m['content']}<|eot_id|>"
                )
            if add_generation_prompt:
                out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
            return "".join(out)
        if self.style == "gemma":
            out = []
            for m in messages:
                role = "model" if m["role"] == "assistant" else "user"
                out.append(f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n")
            if add_generation_prompt:
                out.append("<start_of_turn>model\n")
            return "".join(out)
        if self.style == "phi":
            out = []
            for m in messages:
                out.append(f"<|{m['role']}|>\n{m['content']}<|end|>\n")
            if add_generation_prompt:
                out.append("<|assistant|>\n")
            return "".join(out)
        if self.style == "llama2":
            sys_txt = ""
            out = []
            for m in messages:
                if m["role"] == "system":
                    sys_txt = m["content"]
                elif m["role"] == "user":
                    content = m["content"]
                    if sys_txt:
                        content = f"<<SYS>>\n{sys_txt}\n<</SYS>>\n\n{content}"
                        sys_txt = ""
                    out.append(f"[INST] {content} [/INST]")
                else:
                    out.append(f" {m['content']} ")
            return "".join(out)
        # plain User/Assistant
        out = []
        for m in messages:
            role = m["role"].capitalize()
            out.append(f"{role}: {m['content']}\n")
        if add_generation_prompt:
            out.append("Assistant:")
        return "".join(out)

    def _render_jinja(self, messages, add_generation_prompt: bool,
                      tools=None) -> str:
        import jinja2

        env = jinja2.Environment(
            trim_blocks=True, lstrip_blocks=True,
            extensions=["jinja2.ext.loopcontrols"],
        )
        env.globals["raise_exception"] = _raise_exception
        env.filters["tojson"] = _tojson
        tpl = env.from_string(self.jinja_source or "")
        return tpl.render(
            messages=list(messages),
            add_generation_prompt=add_generation_prompt,
            bos_token="", eos_token="",
            tools=list(tools) if tools else None,
        )


def _jinja_available() -> bool:
    try:
        import jinja2  # noqa: F401

        return True
    except ImportError:
        return False


def _raise_exception(msg):
    raise ValueError(msg)


def _tojson(x, **kw):
    import json

    return json.dumps(x, **kw)
