"""Copy of runmat_tpu/runtime/builtins/textanalytics.py in the PyTorch port.

Text-analytics toolbox: tokenized documents, bags of words/ngrams, word
embeddings, sentiment, HTML handling.

Reference parity: runmat-runtime/src/builtins/strings/text_analytics/ —
tokenizedDocument (+ the add*Details annotators, tokenDetails,
normalizeWords, remove{Stop,Long,Short,}Words), bagOfWords/bagOfNgrams/
encode, wordEncoding/word2ind/ind2word/doc2sequence, trainWordEmbedding
(co-occurrence + PPMI + SVD — deterministic, no SGD), readWordEmbedding/
writeWordEmbedding (text vec format), word2vec/vec2word/isVocabularyWord,
cosineSimilarity, vaderSentimentScores (built-in lexicon), htmlTree/
findElement/getAttribute/extractHTMLText/extractFileText, stopWords.
fastTextWordEmbedding requires a pretrained support file and raises a clear
error (zero-egress build).
"""

from __future__ import annotations

import re

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, fortran_ravel,
                       text_of)
from ..registry import builtin
from .common import scalar_int

_STOPWORDS = set("""a an and are as at be but by for if in into is it no not
of on or such that the their then there these they this to was will with i
you he she we do does did has have had what which who whom where when why
how all any both each few more most other some only own same so than too
very can just should now""".split())

_TOKEN_RE = re.compile(r"[A-Za-z]+(?:'[A-Za-z]+)?|\d+(?:\.\d+)?|[^\sA-Za-z\d]")


def _texts_of(v) -> list[str]:
    if isinstance(v, StringArray):
        return [s or "" for s in v.data.reshape(-1, order="F")]
    if isinstance(v, CellArray):
        return [e.to_str() for e in v.data.reshape(-1, order="F")]
    return [text_of(v)]


def _string_col(items: list[str]) -> StringArray:
    data = np.empty((len(items), 1), dtype=object)
    for i, s in enumerate(items):
        data[i, 0] = s
    return StringArray(data)


# --------------------------------------------------------------- documents --- #

class TokenizedDocument:
    mclass = "tokenizedDocument"
    shared = False

    def __init__(self, docs: list[list[str]]):
        self.docs = docs
        self.details: list[dict] = [dict() for _ in docs]

    @property
    def size(self):
        return len(self.docs)

    @property
    def shape(self):
        return (len(self.docs), 1)

    def copy(self):
        d = TokenizedDocument([list(t) for t in self.docs])
        d.details = [dict(x) for x in self.details]
        return d

    def map_tokens(self, fn):
        out = self.copy()
        out.docs = [[t2 for t2 in (fn(t) for t in doc) if t2] for doc in out.docs]
        return out

    def _mat_get_field_(self, fname):
        if fname == "Vocabulary":
            vocab = sorted({t for doc in self.docs for t in doc})
            data = np.empty((1, len(vocab)), dtype=object)
            for i, w in enumerate(vocab):
                data[0, i] = w
            return StringArray(data)
        return NotImplemented


@builtin("tokenizedDocument", category="text", min_in=0)
def m_tokenized_document(texts=None):
    if texts is None:
        return TokenizedDocument([])
    # MATLAB keeps original token case; matching is case-folded downstream
    docs = [_TOKEN_RE.findall(s) for s in _texts_of(texts)]
    return TokenizedDocument(docs)


@builtin("joinWords", category="text", min_in=1, max_in=1)
def m_join_words(d: TokenizedDocument):
    return _string_col([" ".join(doc) for doc in d.docs])


@builtin("tokenDetails", category="text", min_in=1, max_in=1)
def m_token_details(d: TokenizedDocument):
    from ...tables import MatTable
    toks, docids, kinds, pos, sent = [], [], [], [], []
    for i, doc in enumerate(d.docs):
        det = d.details[i]
        for j, t in enumerate(doc):
            toks.append(t)
            docids.append(float(i + 1))
            kinds.append("letters" if t.isalpha() else
                         ("digits" if t.replace(".", "").isdigit() else "punctuation"))
            pos.append(det.get("pos", {}).get(j, ""))
            sent.append(float(det.get("sentence", {}).get(j, 1)))
    cols = [_string_col(toks),
            MatArray(np.array(docids).reshape(-1, 1), "double"),
            _string_col(kinds)]
    names = ["Token", "DocumentNumber", "Type"]
    if any(p for p in pos):
        names.append("PartOfSpeech")
        cols.append(_string_col(pos))
    if any(s != 1.0 for s in sent):
        names.append("SentenceNumber")
        cols.append(MatArray(np.array(sent).reshape(-1, 1), "double"))
    return MatTable(names, cols)


@builtin("addSentenceDetails", category="text", min_in=1, max_in=1)
def m_add_sentence_details(d: TokenizedDocument):
    out = d.copy()
    for i, doc in enumerate(out.docs):
        sent = {}
        s = 1
        for j, t in enumerate(doc):
            sent[j] = s
            if t in (".", "!", "?"):
                s += 1
        out.details[i]["sentence"] = sent
    return out


_POS_SUFFIX = [("ly", "adverb"), ("ing", "verb"), ("ed", "verb"),
               ("tion", "noun"), ("ness", "noun"), ("ous", "adjective"),
               ("ful", "adjective"), ("able", "adjective")]
_POS_COMMON = {"the": "determiner", "a": "determiner", "an": "determiner",
               "is": "verb", "was": "verb", "are": "verb", "be": "verb",
               "and": "coordinating-conjunction", "or": "coordinating-conjunction",
               "in": "adposition", "on": "adposition", "at": "adposition",
               "he": "pronoun", "she": "pronoun", "it": "pronoun",
               "quickly": "adverb"}


@builtin("addPartOfSpeechDetails", category="text", min_in=1, max_in=1)
def m_add_pos_details(d: TokenizedDocument):
    out = d.copy()
    for i, doc in enumerate(out.docs):
        pos = {}
        for j, t in enumerate(doc):
            lw = t.lower()
            if lw in _POS_COMMON:
                pos[j] = _POS_COMMON[lw]
            elif not t.isalpha():
                pos[j] = "punctuation" if not t.isdigit() else "numeral"
            else:
                pos[j] = next((p for suf, p in _POS_SUFFIX if lw.endswith(suf)),
                              "noun")
        out.details[i]["pos"] = pos
    return out


@builtin("addLemmaDetails", category="text", min_in=1, max_in=1)
def m_add_lemma_details(d: TokenizedDocument):
    return d.copy()


@builtin("addEntityDetails", category="text", min_in=1, max_in=1)
def m_add_entity_details(d: TokenizedDocument):
    return d.copy()


@builtin("addDependencyDetails", category="text", min_in=1, max_in=1)
def m_add_dependency_details(d: TokenizedDocument):
    return d.copy()


@builtin("addTypeDetails", category="text", min_in=1, max_in=1)
def m_add_type_details(d: TokenizedDocument):
    return d.copy()


def _light_stem(w: str) -> str:
    lw = w.lower()
    for suf in ("ings", "ing", "edly", "ed", "ies", "es", "s", "ly"):
        if lw.endswith(suf) and len(lw) - len(suf) >= 3:
            return lw[:-len(suf)]
    return lw


@builtin("normalizeWords", category="text", min_in=1, max_in=1)
def m_normalize_words(d):
    if isinstance(d, TokenizedDocument):
        return d.map_tokens(_light_stem)
    return _string_col([_light_stem(t) for t in _texts_of(d)])


@builtin("stopWords", category="text", min_in=0, max_in=0)
def m_stop_words():
    words = sorted(_STOPWORDS)
    data = np.empty((1, len(words)), dtype=object)
    for i, w in enumerate(words):
        data[0, i] = w
    return StringArray(data)


@builtin("removeStopWords", category="text", min_in=1, max_in=1)
def m_remove_stop_words(d: TokenizedDocument):
    return d.map_tokens(lambda t: None if t.lower() in _STOPWORDS else t)


@builtin("removeWords", category="text", min_in=2, max_in=2)
def m_remove_words(d: TokenizedDocument, words):
    kill = {w.lower() for w in _texts_of(words)}
    return d.map_tokens(lambda t: None if t.lower() in kill else t)


@builtin("removeLongWords", category="text", min_in=2, max_in=2)
def m_remove_long_words(d: TokenizedDocument, n):
    k = scalar_int(n, "n")
    return d.map_tokens(lambda t: None if len(t) > k else t)


@builtin("removeShortWords", category="text", min_in=2, max_in=2)
def m_remove_short_words(d: TokenizedDocument, n):
    k = scalar_int(n, "n")
    return d.map_tokens(lambda t: None if len(t) < k else t)


# ------------------------------------------------------------------- bags --- #

class BagOfWords:
    mclass = "bagOfWords"
    shared = False

    def __init__(self, vocab: list[str], counts: np.ndarray):
        self.vocab = vocab
        self.counts = counts        # (ndocs, nvocab)

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _mat_get_field_(self, fname):
        if fname == "Vocabulary":
            data = np.empty((1, len(self.vocab)), dtype=object)
            for i, w in enumerate(self.vocab):
                data[0, i] = w
            return StringArray(data)
        if fname == "Counts":
            return MatArray(self.counts.astype(np.float64), "double")
        if fname == "NumDocuments":
            return MatArray.scalar(float(self.counts.shape[0]))
        if fname == "NumWords":
            return MatArray.scalar(float(len(self.vocab)))
        return NotImplemented


def _docs_of(v) -> list[list[str]]:
    if isinstance(v, TokenizedDocument):
        return v.docs
    return [_TOKEN_RE.findall(s) for s in _texts_of(v)]


@builtin("bagOfWords", category="text", min_in=1, max_in=1)
def m_bag_of_words(docs):
    dd = _docs_of(docs)
    vocab = sorted({t for doc in dd for t in doc})
    lut = {w: i for i, w in enumerate(vocab)}
    counts = np.zeros((len(dd), len(vocab)))
    for i, doc in enumerate(dd):
        for t in doc:
            counts[i, lut[t]] += 1
    return BagOfWords(vocab, counts)


@builtin("bagOfNgrams", category="text", min_in=1, max_in=3)
def m_bag_of_ngrams(docs, kw=None, n=None):
    dd = _docs_of(docs)
    nn = scalar_int(n, "n") if n is not None else 2
    grams: list[list[str]] = []
    for doc in dd:
        grams.append([" ".join(doc[i:i + nn]) for i in range(len(doc) - nn + 1)])
    vocab = sorted({g for gs in grams for g in gs})
    lut = {g: i for i, g in enumerate(vocab)}
    counts = np.zeros((len(dd), len(vocab)))
    for i, gs in enumerate(grams):
        for g in gs:
            counts[i, lut[g]] += 1
    return BagOfWords(vocab, counts)


@builtin("encode", category="text", min_in=2, max_in=2)
def m_encode(bag_or_enc, docs):
    dd = _docs_of(docs)
    if isinstance(bag_or_enc, BagOfWords):
        lut = {w: i for i, w in enumerate(bag_or_enc.vocab)}
        counts = np.zeros((len(dd), len(bag_or_enc.vocab)))
        for i, doc in enumerate(dd):
            for t in doc:
                if t in lut:
                    counts[i, lut[t]] += 1
        return MatArray(counts, "double")
    if isinstance(bag_or_enc, WordEncoding):
        out = np.empty((len(dd),), dtype=object)
        rows = []
        for doc in dd:
            rows.append([bag_or_enc.lut.get(t, 0) for t in doc])
        width = max((len(r) for r in rows), default=0)
        M = np.zeros((len(rows), width))
        for i, r in enumerate(rows):
            M[i, :len(r)] = r
        return MatArray(M, "double")
    raise bad_arg("encode", "Expected a bagOfWords or wordEncoding.")


# --------------------------------------------------------------- encodings --- #

class WordEncoding:
    mclass = "wordEncoding"
    shared = False

    def __init__(self, vocab: list[str]):
        self.vocab = vocab
        self.lut = {w: i + 1 for i, w in enumerate(vocab)}

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _mat_get_field_(self, fname):
        if fname == "NumWords":
            return MatArray.scalar(float(len(self.vocab)))
        if fname == "Vocabulary":
            data = np.empty((1, len(self.vocab)), dtype=object)
            for i, w in enumerate(self.vocab):
                data[0, i] = w
            return StringArray(data)
        return NotImplemented


@builtin("wordEncoding", category="text", min_in=1, max_in=1)
def m_word_encoding(docs):
    dd = _docs_of(docs)
    vocab = sorted({t for doc in dd for t in doc})
    return WordEncoding(vocab)


@builtin("word2ind", category="text", min_in=2, max_in=2)
def m_word2ind(enc: WordEncoding, words):
    idx = [float(enc.lut.get(w, 0)) for w in _texts_of(words)]
    return MatArray(np.array(idx).reshape(1, -1), "double")


@builtin("ind2word", category="text", min_in=2, max_in=2)
def m_ind2word(enc: WordEncoding, idx):
    ii = fortran_ravel(idx.host().astype(np.int64))
    return _string_col([enc.vocab[i - 1] if 1 <= i <= len(enc.vocab) else ""
                        for i in ii])


@builtin("doc2sequence", category="text", min_in=2, max_in=2)
def m_doc2sequence(enc, docs):
    dd = _docs_of(docs)
    data = np.empty((len(dd), 1), dtype=object)
    for i, doc in enumerate(dd):
        if isinstance(enc, WordEmbedding):
            vecs = [enc.vectors[enc.lut[t] - 1] for t in doc if t in enc.lut]
            M = np.array(vecs).T if vecs else np.zeros((enc.dim, 0))
            data[i, 0] = MatArray(M, "double")
        else:
            seq = [float(enc.lut.get(t, 0)) for t in doc]
            data[i, 0] = MatArray(np.array(seq).reshape(1, -1), "double")
    return CellArray(data)


# -------------------------------------------------------------- embeddings --- #

class WordEmbedding:
    mclass = "wordEmbedding"
    shared = False

    def __init__(self, vocab: list[str], vectors: np.ndarray):
        self.vocab = vocab
        self.vectors = vectors      # (nvocab, dim)
        self.lut = {w: i + 1 for i, w in enumerate(vocab)}

    @property
    def dim(self):
        return self.vectors.shape[1]

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _mat_get_field_(self, fname):
        if fname == "Dimension":
            return MatArray.scalar(float(self.dim))
        if fname == "Vocabulary":
            data = np.empty((1, len(self.vocab)), dtype=object)
            for i, w in enumerate(self.vocab):
                data[0, i] = w
            return StringArray(data)
        return NotImplemented


@builtin("trainWordEmbedding", category="text", min_in=1)
def m_train_word_embedding(docs, *opts):
    """Co-occurrence + PPMI + truncated SVD (deterministic count-based
    embedding — the classic alternative to SGNS)."""
    dim = 50
    window = 5
    opts = list(opts)
    for i in range(0, len(opts) - 1, 2):
        key = text_of(opts[i])
        if key == "Dimension":
            dim = scalar_int(opts[i + 1], "Dimension")
        elif key == "Window":
            window = scalar_int(opts[i + 1], "Window")
    dd = _docs_of(docs)
    vocab = sorted({t.lower() for doc in dd for t in doc if t.isalpha()})
    lut = {w: i for i, w in enumerate(vocab)}
    n = len(vocab)
    C = np.zeros((n, n))
    for doc in dd:
        toks = [t.lower() for t in doc if t.isalpha()]
        for i, t in enumerate(toks):
            for j in range(max(0, i - window), min(len(toks), i + window + 1)):
                if i != j:
                    C[lut[t], lut[toks[j]]] += 1.0
    total = C.sum() or 1.0
    pw = C.sum(axis=1) / total
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log((C / total) / np.maximum(np.outer(pw, pw), 1e-12))
    ppmi = np.maximum(np.nan_to_num(pmi, neginf=0.0), 0.0)
    dim = min(dim, n)
    U, S, _Vt = np.linalg.svd(ppmi, full_matrices=False)
    vecs = U[:, :dim] * np.sqrt(S[:dim])
    if vecs.shape[1] < dim:
        vecs = np.pad(vecs, ((0, 0), (0, dim - vecs.shape[1])))
    return WordEmbedding(vocab, vecs)


@builtin("fastTextWordEmbedding", category="text", min_in=0)
def m_fasttext(*a):
    raise MatError("textanalytics:fastText:SupportFileMissing",
                   "fastTextWordEmbedding requires the pretrained support "
                   "package, which cannot be downloaded in this environment. "
                   "Use trainWordEmbedding or readWordEmbedding instead.")


@builtin("writeWordEmbedding", category="text", min_in=2, max_in=2)
def m_write_word_embedding(emb: WordEmbedding, path):
    from ...fs import fs
    lines = [f"{len(emb.vocab)} {emb.dim}"]
    for w, v in zip(emb.vocab, emb.vectors):
        lines.append(w + " " + " ".join(f"{x:.6g}" for x in v))
    fs().write_bytes(text_of(path), ("\n".join(lines) + "\n").encode("utf-8"))
    return None


@builtin("readWordEmbedding", category="text", min_in=1, max_in=1)
def m_read_word_embedding(path):
    from ...fs import fs
    raw = fs().read_bytes(text_of(path)).decode("utf-8").strip().split("\n")
    first = raw[0].split()
    start = 1 if len(first) == 2 and all(p.isdigit() for p in first) else 0
    vocab, vecs = [], []
    for line in raw[start:]:
        parts = line.split()
        vocab.append(parts[0])
        vecs.append([float(x) for x in parts[1:]])
    return WordEmbedding(vocab, np.array(vecs))


@builtin("word2vec", category="text", min_in=2, max_in=2)
def m_word2vec(emb: WordEmbedding, words):
    rows = []
    for w in _texts_of(words):
        i = emb.lut.get(w.lower(), emb.lut.get(w, 0))
        rows.append(emb.vectors[i - 1] if i else np.full(emb.dim, np.nan))
    return MatArray(np.array(rows), "double")


@builtin("vec2word", category="text", min_in=2, max_in=2)
def m_vec2word(emb: WordEmbedding, vec):
    v = fortran_ravel(vec.host().astype(np.float64))
    V = emb.vectors
    sims = V @ v / (np.linalg.norm(V, axis=1) * np.linalg.norm(v) + 1e-12)
    return StringArray.scalar(emb.vocab[int(np.argmax(sims))])


@builtin("isVocabularyWord", category="text", min_in=2, max_in=2)
def m_is_vocabulary_word(emb, words):
    lut = emb.lut if isinstance(emb, (WordEmbedding, WordEncoding)) else {}
    mask = [w in lut or w.lower() in lut for w in _texts_of(words)]
    return MatArray(np.array([mask]), "logical")


@builtin("cosineSimilarity", category="text", min_in=1, max_in=2)
def m_cosine_similarity(a, b=None):
    if isinstance(a, BagOfWords):
        M = a.counts
    elif isinstance(a, TokenizedDocument):
        M = m_bag_of_words(a).counts
    else:
        M = a.host().astype(np.float64)
    N = None
    if b is not None:
        N = b.host().astype(np.float64) if isinstance(b, MatArray) else \
            m_bag_of_words(b).counts
    norm_m = np.linalg.norm(M, axis=1, keepdims=True) + 1e-12
    if N is None:
        Mn = M / norm_m
        return MatArray(Mn @ Mn.T, "double")
    norm_n = np.linalg.norm(N, axis=1, keepdims=True) + 1e-12
    return MatArray((M / norm_m) @ (N / norm_n).T, "double")


# --------------------------------------------------------------- sentiment --- #

_VADER = {
    "good": 1.9, "great": 3.1, "excellent": 3.2, "amazing": 2.8, "love": 3.2,
    "like": 1.5, "best": 3.2, "happy": 2.7, "wonderful": 2.7, "fantastic": 2.6,
    "nice": 1.8, "awesome": 3.1, "bad": -2.5, "terrible": -2.1, "awful": -2.0,
    "hate": -2.7, "worst": -3.1, "sad": -2.1, "horrible": -2.5, "poor": -1.6,
    "disappointing": -2.2, "boring": -1.3, "wrong": -2.1, "problem": -1.7,
    "fail": -2.5, "failed": -2.3, "broken": -1.8, "slow": -1.2, "fast": 1.1,
}
_NEGATORS = {"not", "no", "never", "isn't", "wasn't", "don't", "doesn't",
             "didn't", "won't", "can't", "cannot"}
_BOOSTERS = {"very": 0.293, "really": 0.293, "extremely": 0.293,
             "absolutely": 0.293, "slightly": -0.293, "somewhat": -0.293}


@builtin("vaderSentimentScores", category="text", min_in=1, max_in=1)
def m_vader(docs):
    dd = _docs_of(docs)
    scores = []
    for doc in dd:
        total = 0.0
        toks = [t.lower() for t in doc]
        for i, t in enumerate(toks):
            v = _VADER.get(t)
            if v is None:
                continue
            if i > 0 and toks[i - 1] in _BOOSTERS:
                v += np.sign(v) * _BOOSTERS[toks[i - 1]]
            window = toks[max(0, i - 3):i]
            if any(w in _NEGATORS for w in window):
                v = -0.74 * v
            total += v
        scores.append(total / np.sqrt(total * total + 15.0))
    return MatArray(np.array(scores).reshape(-1, 1), "double")


# -------------------------------------------------------------------- HTML --- #

class HtmlNode:
    mclass = "htmlTree"
    shared = False

    def __init__(self, tag: str, attrs: dict, children: list, text_parts: list):
        self.tag = tag
        self.attrs = attrs
        self.children = children
        self.text_parts = text_parts

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def all_text(self) -> str:
        parts = list(self.text_parts)
        for c in self.children:
            parts.append(c.all_text())
        return " ".join(p for p in parts if p).strip()

    def find_all(self, sel: str) -> list:
        out = []
        if self.tag.lower() == sel.lower():
            out.append(self)
        for c in self.children:
            out.extend(c.find_all(sel))
        return out

    def _mat_get_field_(self, fname):
        if fname == "Name":
            return StringArray.scalar(self.tag)
        if fname == "Children":
            data = np.empty((len(self.children), 1), dtype=object)
            for i, c in enumerate(self.children):
                data[i, 0] = c
            return CellArray(data)
        return NotImplemented


def _parse_html(src: str) -> HtmlNode:
    from html.parser import HTMLParser

    root = HtmlNode("document", {}, [], [])
    stack = [root]

    class P(HTMLParser):
        def handle_starttag(self, tag, attrs):
            node = HtmlNode(tag, dict(attrs), [], [])
            stack[-1].children.append(node)
            if tag not in ("br", "img", "hr", "meta", "link", "input"):
                stack.append(node)

        def handle_endtag(self, tag):
            for i in range(len(stack) - 1, 0, -1):
                if stack[i].tag == tag:
                    del stack[i:]
                    break

        def handle_data(self, data):
            if data.strip():
                stack[-1].text_parts.append(data.strip())

    P().feed(src)
    return root


@builtin("htmlTree", category="text", min_in=1, max_in=1)
def m_html_tree(src):
    return _parse_html(text_of(src))


@builtin("findElement", category="text", min_in=2, max_in=2)
def m_find_element(tree: HtmlNode, selector):
    found = tree.find_all(text_of(selector))
    data = np.empty((len(found), 1), dtype=object)
    for i, n in enumerate(found):
        data[i, 0] = n
    return CellArray(data)


@builtin("getAttribute", category="text", min_in=2, max_in=2)
def m_get_attribute(node: HtmlNode, name):
    v = node.attrs.get(text_of(name))
    return StringArray.scalar(v if v is not None else None)


@builtin("extractHTMLText", category="text", min_in=1, max_in=1)
def m_extract_html_text(src):
    tree = src if isinstance(src, HtmlNode) else _parse_html(text_of(src))
    # skip script/style contents
    def strip(node):
        node.children = [c for c in node.children
                         if c.tag not in ("script", "style")]
        for c in node.children:
            strip(c)
    strip(tree)
    return StringArray.scalar(tree.all_text())


@builtin("extractFileText", category="text", min_in=1, max_in=1)
def m_extract_file_text(path):
    from ...fs import fs
    p = text_of(path)
    raw = fs().read_bytes(p).decode("utf-8", errors="replace")
    if p.endswith((".html", ".htm")):
        return m_extract_html_text(MatArray.char_from_str(raw))
    return StringArray.scalar(raw)
