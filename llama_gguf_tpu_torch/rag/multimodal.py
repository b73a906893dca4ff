"""Multi-modal content extraction for RAG (port of
llama_gguf_tpu/rag/multimodal.py, the same code).

Type detection and extraction of code blocks, image references and tables
from markdown, so each modality can be chunked, embedded and filtered
separately: a position cursor scans for the three delimiters (```, ![ and
a line-leading |).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class ContentType(str, Enum):
    TEXT = "text"
    IMAGE = "image"
    TABLE = "table"
    CODE = "code"
    MIXED = "mixed"


class TableFormat(str, Enum):
    MARKDOWN = "markdown"
    CSV = "csv"
    PLAIN = "plain"


@dataclass
class ContentElement:
    content_type: ContentType
    text: str
    source_uri: str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class MultiModalDocument:
    source_uri: str
    elements: list[ContentElement]
    raw_text: str

    def by_type(self, t: ContentType) -> list[ContentElement]:
        return [e for e in self.elements if e.content_type == t]


@dataclass
class ExtractionConfig:
    extract_tables: bool = True
    extract_code_blocks: bool = True
    extract_image_refs: bool = True
    table_format: TableFormat = TableFormat.MARKDOWN


def _is_table_line(line: str) -> bool:
    t = line.strip()
    return t.startswith("|") and t.endswith("|") and len(t) > 2


def _is_separator_line(line: str) -> bool:
    t = line.strip()
    if not (t.startswith("|") and t.endswith("|")):
        return False
    return all(all(ch in "-:" for ch in cell.strip())
               for cell in t[1:-1].split("|"))


class ContentExtractor:
    def __init__(self, config: ExtractionConfig | None = None):
        self.config = config or ExtractionConfig()

    # -- markdown ------------------------------------------------------------

    def extract_markdown(self, text: str,
                         source_uri: str | None = None) -> MultiModalDocument:
        uri = source_uri or ""
        elements: list[ContentElement] = []
        i, n = 0, len(text)
        while i < n:
            if self.config.extract_code_blocks and text.startswith("```", i):
                element, advance = self._parse_code_block(text[i:], uri)
                elements.append(element)
                i += advance
                continue
            if self.config.extract_image_refs and text.startswith("![", i):
                element, advance = self._parse_image_ref(text[i:], uri)
                elements.append(element)
                i += max(advance, 1)
                continue
            if self.config.extract_tables and (i == 0 or text[i - 1] == "\n"):
                eol = text.find("\n", i)
                line = text[i: eol if eol >= 0 else n]
                if _is_table_line(line):
                    lines, advance = self._collect_table_lines(text[i:])
                    if len(lines) >= 2:
                        elements.append(self._parse_table(lines, uri))
                        i += advance
                        continue
            # plain text: up to the next special marker
            j = i
            while j < n:
                if text.startswith("```", j) or text.startswith("![", j):
                    break
                if j > 0 and text[j - 1] == "\n" and text[j] == "|":
                    break
                j += 1
            chunk = text[i:j].strip()
            if chunk:
                elements.append(ContentElement(
                    ContentType.TEXT, chunk, uri or None,
                    {"char_count": len(chunk)}))
            i = max(j, i + 1)
        return MultiModalDocument(uri, elements, text)

    def extract_plain(self, text: str,
                      source_uri: str | None = None) -> MultiModalDocument:
        uri = source_uri or ""
        t = text.strip()
        elements = [] if not t else [ContentElement(
            ContentType.TEXT, t, uri or None, {"char_count": len(t)})]
        return MultiModalDocument(uri, elements, text)

    # -- element parsers -----------------------------------------------------

    @staticmethod
    def _parse_code_block(s: str, uri: str) -> tuple[ContentElement, int]:
        i = 3  # skip ```
        lang = ""
        while i < len(s) and s[i] not in "\n`":
            lang += s[i]
            i += 1
        if i < len(s) and s[i] == "\n":
            i += 1
        end = s.find("```", i)
        if end < 0:
            end = len(s)
            advance = end
        else:
            advance = end + 3
        content = s[i:end]
        return ContentElement(
            ContentType.CODE, content, uri or None,
            {"language": lang.strip(),
             "line_count": len(content.splitlines())}), advance

    @staticmethod
    def _parse_image_ref(s: str, uri: str) -> tuple[ContentElement, int]:
        close = s.find("]", 2)
        if close < 0:
            return ContentElement(ContentType.IMAGE, "", None, {}), 2
        alt = s[2:close]
        if close + 1 >= len(s) or s[close + 1] != "(":
            return ContentElement(ContentType.IMAGE, alt, None, {}), close + 1
        url_end = s.find(")", close + 2)
        if url_end < 0:
            url_end = len(s)
            advance = url_end
        else:
            advance = url_end + 1
        url = s[close + 2: url_end]
        return ContentElement(
            ContentType.IMAGE, url, uri or None,
            {"alt_text": alt, "url": url}), advance

    @staticmethod
    def _collect_table_lines(s: str) -> tuple[list[str], int]:
        lines = []
        i = 0
        while i < len(s):
            eol = s.find("\n", i)
            line = s[i: eol if eol >= 0 else len(s)]
            if not _is_table_line(line):
                break
            lines.append(line)
            i = (eol + 1) if eol >= 0 else len(s)
        return lines, i

    def _parse_table(self, lines: list[str], uri: str) -> ContentElement:
        data_rows = [ln for ln in lines if not _is_separator_line(ln)]
        cols = len([c for c in lines[0].split("|") if c.strip()]) if lines else 0

        def cells(ln: str) -> list[str]:
            return [c.strip() for c in ln.strip().strip("|").split("|")]

        if self.config.table_format == TableFormat.CSV:
            text = "\n".join(",".join(cells(ln)) for ln in data_rows)
        elif self.config.table_format == TableFormat.PLAIN:
            text = "\n".join(" ".join(cells(ln)) for ln in data_rows)
        else:
            text = "\n".join(lines)
        return ContentElement(
            ContentType.TABLE, text, uri or None,
            {"rows": len(data_rows), "cols": cols,
             "header": lines[0] if lines else ""})

    # -- type detection ------------------------------------------------------

    @staticmethod
    def detect_content_type(text: str) -> ContentType:
        has_table = any(_is_table_line(line) for line in text.splitlines())
        has_code = "```" in text
        has_image = "![" in text and "](" in text
        t = text.strip()
        all_table = bool(t) and all(
            not line.strip() or _is_table_line(line)
            for line in text.splitlines())
        solely_code = (t.startswith("```") and t.endswith("```")
                       and t.count("```") == 2)
        non_empty = [line for line in text.splitlines() if line.strip()]
        solely_image = (has_image and not has_table and not has_code
                        and len(non_empty) <= 1)
        has_other = bool(t) and not all_table and not solely_code \
            and not solely_image
        count = sum([has_table, has_code, has_image, has_other])
        if count > 1:
            return ContentType.MIXED
        if has_table:
            return ContentType.TABLE
        if has_code:
            return ContentType.CODE
        if has_image:
            return ContentType.IMAGE
        return ContentType.TEXT
