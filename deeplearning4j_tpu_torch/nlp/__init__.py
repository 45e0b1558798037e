"""NLP of the port: tokenizers and the BERT masked-LM / classification
iterator."""
from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    BertWordPieceTokenizer, CommonPreprocessor, DefaultTokenizerFactory)
from deeplearning4j_tpu_torch.nlp.bert_iterator import BertIterator  # noqa: F401
